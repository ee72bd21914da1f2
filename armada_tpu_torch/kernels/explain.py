"""Wrapper of kernel K-J (csrc/explain.cu): the explain pass.  CPU inputs
run the plain version (models/explain.py explain_kernel_plain)."""

from __future__ import annotations

import ctypes

import torch

from armada_tpu_torch import kernels
from armada_tpu_torch.kernels.build import check, library, require_cuda, stream_handle

_IN = ("compat", "compat_pre_type", "node_type", "node_ok", "node_total", "node_axes",
       "g_req", "g_card", "g_queue", "g_key", "g_run", "g_valid", "g_absent", "g_state",
       "alloc0", "q_killed")
_SCRATCH = ("req_k", "free_", "key_ok", "reason_g", "cfailed", "kr", "key_count",
            "key_reason", "key_has", "offsets", "totals", "wbuf", "out")
_INTS = ("N", "R", "G", "K", "T", "Q", "real_g", "kcap", "fcap")
_DTYPES = dict(
    compat=torch.bool, compat_pre_type=torch.bool, node_type=torch.int32, node_ok=torch.bool,
    node_total=torch.float32, node_axes=torch.float32, g_req=torch.float32,
    g_card=torch.int32, g_queue=torch.int32, g_key=torch.int32, g_run=torch.int32,
    g_valid=torch.bool, g_absent=torch.bool, g_state=torch.int32, alloc0=torch.float32,
    q_killed=torch.bool,
)
NUM_REASONS = 7


class ExplainArgs(ctypes.Structure):
    _fields_ = [(n, ctypes.c_void_p) for n in _IN + _SCRATCH] + [
        (n, ctypes.c_int) for n in _INTS
    ]


def explain_round(compat, compat_pre_type, node_type, node_ok, node_total, node_axes, g_req,
                  g_card, g_queue, g_key, g_run, g_valid, g_absent, g_state, alloc, q_killed,
                  num_real_gangs: int, *, kcap: int, fcap: int) -> torch.Tensor:
    """i32 explain buffer (layout in models/explain.py).  CPU inputs run the
    plain version; CUDA inputs the kernel."""
    args = (compat, compat_pre_type, node_type, node_ok, node_total, node_axes, g_req, g_card,
            g_queue, g_key, g_run, g_valid, g_absent, g_state, alloc, q_killed)
    if not g_state.is_cuda:
        from armada_tpu_torch.models.explain import explain_kernel_plain

        return explain_kernel_plain(*args, num_real_gangs, kcap=kcap, fcap=fcap)
    from armada_tpu_torch.models.explain import explain_len

    src = dict(zip(_IN, args))
    src["alloc0"] = alloc[0]
    for name, dt in _DTYPES.items():
        require_cuda(src[name], name, dt)
    K, T = (int(x) for x in compat.shape)
    N, R = (int(x) for x in node_total.shape)
    G = int(g_state.shape[0])
    Q = int(q_killed.shape[0])
    if (tuple(compat_pre_type.shape) != (K, T) or tuple(g_req.shape) != (G, R)
            or tuple(src["alloc0"].shape) != (N, R) or int(node_type.shape[0]) != N):
        raise ValueError("explain_round: inputs disagree in shape")
    if not (0 <= kcap <= K and 0 <= fcap <= G) or R > 32 or K > 65535:
        raise ValueError("explain_round: caps or axes outside what the kernel takes")
    dev = g_state.device
    nb_k, nb_g = max(1, -(-K // 1024)), max(1, -(-G // 1024))
    wcap = -(-N // 32) + 1
    f32, i32, u8 = torch.float32, torch.int32, torch.uint8
    src.update(
        req_k=torch.empty((K, R), dtype=f32, device=dev),
        free_=torch.empty((N, R), dtype=f32, device=dev),
        key_ok=torch.empty((K, 3), dtype=u8, device=dev),
        reason_g=torch.empty((G,), dtype=i32, device=dev),
        cfailed=torch.empty((G,), dtype=u8, device=dev),
        kr=torch.empty((K, NUM_REASONS), dtype=i32, device=dev),
        key_count=torch.empty((K,), dtype=i32, device=dev),
        key_reason=torch.empty((K,), dtype=i32, device=dev),
        key_has=torch.empty((K,), dtype=u8, device=dev),
        offsets=torch.empty((nb_k + nb_g,), dtype=i32, device=dev),
        totals=torch.empty((2,), dtype=i32, device=dev),
        wbuf=torch.empty((2 * wcap * R,), dtype=f32, device=dev),
        out=torch.empty((explain_len(Q, R, T, kcap, fcap),), dtype=i32, device=dev),
    )
    lib = library()
    if ctypes.sizeof(ExplainArgs) != lib.armada_explain_args_size():
        raise RuntimeError("ExplainArgs layout differs between Python and csrc/explain.cu")
    a = ExplainArgs()
    for name in _IN + _SCRATCH:
        setattr(a, name, src[name].data_ptr())
    for name, v in zip(_INTS, (N, R, G, K, T, Q, int(num_real_gangs), int(kcap), int(fcap))):
        setattr(a, name, v)
    if lib.armada_explain_len(ctypes.byref(a)) != src["out"].numel():
        raise RuntimeError("explain buffer length differs between Python and csrc/explain.cu")
    check(lib.armada_explain(ctypes.byref(a), stream_handle()), "explain kernel")
    kernels.LAUNCHES["explain"] += 1
    return src["out"]
