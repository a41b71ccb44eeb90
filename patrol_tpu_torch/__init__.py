"""patrol_tpu_torch — the PyTorch/CUDA port of patrol_tpu.

The same distributed rate limiter (token buckets as CRDT PN-counters in
dense int64 device state), with plain tensor code in PyTorch and the
kernels on the serving path written by hand for NVIDIA Hopper
(``csrc/*.cu``, built with nvcc on first use). ``patrol_tpu`` (JAX) is
the reference this package is held to bit for bit; nothing here imports
it or JAX.
"""

from patrol_tpu_torch.ops.rate import (
    Rate,
    parse_rate,
    parse_duration,
    format_duration,
)
from patrol_tpu_torch.runtime.bucket import Bucket, LocalRepo

__version__ = "0.1.0"

__all__ = [
    "Rate",
    "parse_rate",
    "parse_duration",
    "format_duration",
    "Bucket",
    "LocalRepo",
    "__version__",
]
