"""Dense device-resident limiter state as int64 torch tensors — the
counterpart of ``patrol_tpu/models/limiter.py``.

* ``pn: int64[B, N, 2]`` — B bucket slots × N node lanes × (ADDED, TAKEN)
  in fixed-point *nanotokens* (1 token = 1e9 nanotokens). A PN-counter:
  node ``i`` only ever increments its own ``pn[:, i, :]`` lane; remote
  lanes change only by elementwise max-merge. Bucket value =
  ``capacity + Σadded − Σtaken``.
* ``elapsed: int64[B]`` — per-bucket G-counter of nanoseconds consumed by
  successful takes, merged by max.

Everything not replicated (name→row mapping, per-row ``created`` stamps,
the lazily-initialized capacity base) lives on the host in the bucket
directory. Where the JAX package donated state buffers to each kernel
call, this package updates the two tensors IN PLACE: a ``LimiterState``
is a pair of long-lived tensors that the kernels mutate.

:func:`state_from_numpy` / :func:`state_to_numpy` carry the planes across
packages as numpy arrays (this system's counterpart of converting
weights): a test loads the JAX package's planes into the port and reads
them back bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

NANO = 1_000_000_000

ADDED = 0  # pn[..., ADDED]: granted refills + nothing else
TAKEN = 1  # pn[..., TAKEN]: successfully taken tokens


class LimiterState(NamedTuple):
    """The replicated CRDT planes, both int64 tensors on one device."""

    pn: torch.Tensor  # int64[B, N, 2] nanotokens
    elapsed: torch.Tensor  # int64[B] nanoseconds

    @property
    def num_buckets(self) -> int:
        return self.pn.shape[0]

    @property
    def num_nodes(self) -> int:
        return self.pn.shape[1]


@dataclasses.dataclass(frozen=True)
class LimiterConfig:
    """Shape configuration for a limiter instance: ``buckets`` row slots
    in the pre-allocated pool, ``nodes`` PN lanes (the cluster bound)."""

    buckets: int = 4096
    nodes: int = 8

    def hbm_bytes(self) -> int:
        return self.buckets * self.nodes * 2 * 8 + self.buckets * 8


# The north-star scale from BASELINE.json: 1M buckets × 256 node slots.
FLAGSHIP = LimiterConfig(buckets=1_000_000, nodes=256)

# A small config for tests and single-host deployments.
SMALL = LimiterConfig(buckets=1024, nodes=8)


def resolve_device(device) -> torch.device:
    """The package's device rule: CUDA unless the caller asks for the CPU.
    Asking for CUDA on a host without a card raises — there is no silent
    fallback to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run on the host"
        )
    return dev


def init_state(config: LimiterConfig, device="cuda") -> LimiterState:
    """Zero state: every bucket empty, which reads as full-at-capacity on
    first take (value = capacity + 0 − 0)."""
    dev = resolve_device(device)
    pn = torch.zeros((config.buckets, config.nodes, 2), dtype=torch.int64, device=dev)
    elapsed = torch.zeros((config.buckets,), dtype=torch.int64, device=dev)
    return LimiterState(pn=pn, elapsed=elapsed)


def state_from_numpy(pn: np.ndarray, elapsed: np.ndarray, device="cuda") -> LimiterState:
    """Load host planes (e.g. ``np.asarray`` of the JAX package's state)
    onto ``device`` as a fresh, contiguous int64 state."""
    pn = np.asarray(pn)
    elapsed = np.asarray(elapsed)
    if pn.ndim != 3 or pn.shape[2] != 2 or elapsed.shape != (pn.shape[0],):
        raise ValueError(
            f"planes must be pn[B,N,2] and elapsed[B], got {pn.shape} and {elapsed.shape}"
        )
    dev = resolve_device(device)
    return LimiterState(
        pn=torch.tensor(pn.astype(np.int64, copy=False), dtype=torch.int64, device=dev),
        elapsed=torch.tensor(
            elapsed.astype(np.int64, copy=False), dtype=torch.int64, device=dev
        ),
    )


def state_to_numpy(state: LimiterState) -> Tuple[np.ndarray, np.ndarray]:
    """Read both planes back to host numpy arrays (a copy)."""
    return state.pn.cpu().numpy().copy(), state.elapsed.cpu().numpy().copy()
