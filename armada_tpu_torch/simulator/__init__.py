"""Discrete-event scheduler simulator (the reference's cmd/simulator and
internal/scheduler/simulator), PyTorch counterpart of the JAX package's
simulator: drives the port's round (the CUDA kernels on a card, the plain
version on the CPU) through virtual time from declarative cluster/workload
specs."""

from armada_tpu_torch.simulator.simulator import CycleStats, SimulationResult, Simulator
from armada_tpu_torch.simulator.spec import (
    ClusterSpec,
    ClusterTemplate,
    JobTemplate,
    NodeTemplate,
    QueueSpec,
    RepeatDetails,
    ShiftedExponential,
    WorkloadSpec,
    cluster_spec_from_dict,
    cluster_spec_from_yaml,
    parse_duration,
    workload_spec_from_dict,
    workload_spec_from_yaml,
)
from armada_tpu_torch.simulator.sink import JsonlSink, write_parquet

__all__ = [
    "Simulator",
    "SimulationResult",
    "CycleStats",
    "ClusterSpec",
    "ClusterTemplate",
    "NodeTemplate",
    "WorkloadSpec",
    "QueueSpec",
    "JobTemplate",
    "RepeatDetails",
    "ShiftedExponential",
    "parse_duration",
    "cluster_spec_from_dict",
    "cluster_spec_from_yaml",
    "workload_spec_from_dict",
    "workload_spec_from_yaml",
    "JsonlSink",
    "write_parquet",
]
