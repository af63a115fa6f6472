"""The registry of the port's auditable programs and the suppression
discipline their cost baselines use.

Counterpart of `skellysim_tpu.audit` in the part the cost gate
(`obs.cost`) stands on: `engine` (`Finding`, the ``[[suppress]]``
entries and `apply_suppressions`), `registry` (`AuditProgram`,
`BuiltProgram`), `fixtures` (the scenes) and `programs` (`all_programs`,
`get_program`). The JAX package's jaxpr and HLO checks (collectives,
dtype flow, host syncs, donation, retraces, DMA, masks, replication) read
XLA's lowered programs, which eager torch has none of; what they
guarantee is held by the port's tests instead (ROADMAP.md §1).

Importing this package touches neither CUDA nor the simulation stack:
each layer's ``auditable_programs()`` is imported when the registry is
read.
"""
