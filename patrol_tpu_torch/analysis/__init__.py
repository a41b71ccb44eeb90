"""The port's check stages (counterpart of ``patrol_tpu/analysis``).

Three stages so far, each with a driver in ``patrol_tpu_torch/scripts/``:

* :mod:`~patrol_tpu_torch.analysis.protocol` — the replication protocol's
  bounded model checker (``protocol_repo.py``, PTC001-006);
* :mod:`~patrol_tpu_torch.analysis.linearizability` — replication-aware
  linearizability against sequential specs pinned to the port's kernels
  (``lin_repo.py``, PTN001-005);
* :mod:`~patrol_tpu_torch.analysis.abi` — the port's C++ library (fold,
  classify, host-lane store, rx ring, effects table) against the merge
  kernels and Python references (``abi_repo.py``, PTA001-005), on the
  CPU or on the card.

The registry they read is :mod:`patrol_tpu_torch.ops.obligations`.
:mod:`~patrol_tpu_torch.analysis.lint` holds only the findings and
inline-suppression machinery these stages share; its AST checks, and the
race, cert, prove and dispatch stages, are not ported yet.
"""
