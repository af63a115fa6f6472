"""skelly-audit for the port: the runtime program auditor.

Counterpart of `skellysim_tpu.audit`, under its check ids, contract
sections and CLI. The JAX package traces and lowers each registered entry
point and reads the jaxpr and StableHLO; eager torch has neither, so the
port runs each registered program once on its fixture under
`observe.Observer` (a dispatch mode over every aten op, a function mode
for the reads that dispatch none, the `parallel.spmd.Collectives` seam)
and checks what the run did against ``audit/contracts/<name>.toml``:

* ``collective-contract`` — each collective kind's calls, call sites and
  largest operand a shard;
* ``dtype-flow`` — float edges (casts between float dtypes, both ways)
  and mixed float32 / float64 ops, by call site;
* ``host-sync`` — reads of device values, ops that wait to size their
  output, blocking uploads (on the card, one for one what
  ``torch.cuda.set_sync_debug_mode`` warns about);
* ``donation`` — the arguments' bits after the call;
* ``retrace-budget`` — what a second call of the same structure rebuilds
  (libraries, host plans, kept geometry, cached tables);
* ``fft-inventory`` — FFT sites;
* ``replication`` — the sharded step's replicated outputs and every
  collective's result the same bits on every shard (`repflow`);
* ``dma`` — kernels A-H on the card: registers, shared bytes and spills,
  and 20 back-to-back launches at a ragged shape (`dmaflow`);
* ``mask`` — the dead capacity slots poisoned, the live outputs' bits
  kept, each output's pad class pinned (`maskflow`).

A run shows the fixture on one backend, not every input, where the static
analyses prove a property for all of them; ROADMAP.md §3 lists each
check's limit. Modules: `registry` (`AuditProgram`, `BuiltProgram`,
`AuditKernel`, the rebuild counts), `programs` / `kernels` (the
registries), `fixtures` (the scenes), `observe`, `checks`, `engine`
(contracts, suppressions, `ProgramRun`, the drivers, ``--dump-contract``),
`maskflow`, `repflow`, `dmaflow` and `cli` (``python -m
skellysim_tpu_torch.audit``; exit 0 clean, 1 findings, 2 usage). The cost
gate (`obs.cost`) stands on the same registry and suppression rules.

Importing this package touches neither CUDA nor the simulation stack:
each layer's ``auditable_programs()`` / ``auditable_kernels()`` is
imported when a registry is read.
"""
