"""Carrying a scheduling problem and a round result across the host/device
boundary.

`problem_from_numpy` takes any object with the 47 SchedulingProblem fields
as numpy arrays (the port's own build_problem output, or the JAX package's
-- the tests feed both sides identical arrays this way) and returns the
port's SchedulingProblem of tensors on `device`, with the same field names,
dtypes and shapes: i32 stays i32 here, and the round converts indices to
int64 where it indexes.  `result_to_numpy` is the inverse for a RoundResult.
"""

from __future__ import annotations

import numpy as np
import torch

from armada_tpu_torch.models.problem import SchedulingProblem


def problem_from_numpy(problem, device) -> SchedulingProblem:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("problem_from_numpy: no CUDA device")
    fields = {}
    for name in SchedulingProblem._fields:
        arr = getattr(problem, name)
        if isinstance(arr, torch.Tensor):
            fields[name] = arr.to(device)
        else:
            # a copy: the round never writes into the caller's arrays, and
            # 0-d scalars stay 0-d (np.ascontiguousarray would make them 1-d)
            fields[name] = torch.tensor(np.asarray(arr), device=device)
    return SchedulingProblem(**fields)


def problem_device(problem) -> torch.device:
    """The one device every tensor of `problem` lies on (raises if mixed)."""
    devs = {getattr(problem, n).device for n in SchedulingProblem._fields}
    if len(devs) != 1:
        raise ValueError(f"problem tensors lie on several devices: {sorted(map(str, devs))}")
    return devs.pop()


def result_to_numpy(result):
    """A RoundResult of tensors as a RoundResult of numpy arrays (0-d for the
    scalars), for comparison with the JAX package's result."""
    return type(result)(*(np.asarray(getattr(result, n).cpu()) for n in result._fields))
