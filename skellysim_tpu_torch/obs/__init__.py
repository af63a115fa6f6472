"""Runtime observation: the physics flight recorder (`obs.flight`), the
span tracer (`obs.tracer`), the latency histograms (`obs.hist`), the
report fold (`obs.summarize`), device-time attribution from
`torch.profiler` dumps (`obs.profile`), the merged timeline
(`obs.timeline`), the program cost counter and its baselines
(`obs.cost`), the roofline join (`obs.roofline`) and their CLI
(``python -m skellysim_tpu_torch.obs``).

Counterpart of `skellysim_tpu.obs`; the benchmark's history gate
(`obs.perf`, ``campaign``) is ROADMAP.md §1 item 14.
"""
