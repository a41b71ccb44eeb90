"""The port's check stages (counterpart of ``patrol_tpu/analysis``).

Eight stages, each with a driver in ``patrol_tpu_torch/scripts/``, and a
runner over them, ``scripts/check.sh`` (the eight, the clang-tidy and
sanitizer stages ``tidy`` and ``san``, the opt-in ``asan-py``; CI gate
``scripts/ci_gate.sh``):

* :mod:`~patrol_tpu_torch.analysis.lint` — the AST lint over the port's
  own sources (``lint_repo.py``, PTL001-007; PTL002 is the CUDA
  counterpart: no host-device sync reachable from a kernel launch, nor in
  the ``extern "C"`` entry it calls), plus the findings and
  inline-suppression machinery every stage shares;
* :mod:`~patrol_tpu_torch.analysis.race` — the epoll-seam schedule
  explorer and the guarded-state, lock-graph, condvar and ownership
  checks over the port's thread ensemble (``race_repo.py``, PTR001-005);
* :mod:`~patrol_tpu_torch.analysis.protocol` — the replication protocol's
  bounded model checker (``protocol_repo.py``, PTC001-006);
* :mod:`~patrol_tpu_torch.analysis.linearizability` — replication-aware
  linearizability against sequential specs pinned to the port's kernels
  (``lin_repo.py``, PTN001-005);
* :mod:`~patrol_tpu_torch.analysis.abi` — the port's C++ library (fold,
  classify, host-lane store, rx ring, effects table) against the merge
  kernels and Python references (``abi_repo.py``, PTA001-005), on the
  CPU or on the card;
* :mod:`~patrol_tpu_torch.analysis.prove` — the CRDT obligations of every
  kernel root: a structural run under a taint-tracking dispatch mode, the
  ``.cu`` join scan, the small-domain models through the kernels
  (``prove_repo.py``, PTP001-006), on the CPU or on the card;
* :mod:`~patrol_tpu_torch.analysis.dispatch` — no hidden host wait on the
  serve graph, a complete dispatch registry, and the witness of every
  serving path under torch's sync detector (``dispatch_repo.py``,
  PTD003-005; PTD001/PTD002 are absences on record);
* :mod:`~patrol_tpu_torch.analysis.cert` — the meta-check over the
  family records: every family reaches every stage it should or says why
  not, every seeded mutation is rejected with its exact code (the prove
  mutants on the CPU or on the card), every absent obligation is
  justified, every kernel launcher is registered (``cert_repo.py``,
  PTK001-005).

The registry the last six read is :mod:`patrol_tpu_torch.ops.obligations`.
"""
