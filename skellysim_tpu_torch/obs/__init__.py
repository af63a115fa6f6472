"""Runtime observation: the physics flight recorder (`obs.flight`), the
span tracer (`obs.tracer`), the latency histograms (`obs.hist`), the
report fold (`obs.summarize`), device-time attribution from
`torch.profiler` dumps (`obs.profile`), the merged timeline
(`obs.timeline`) and their CLI (``python -m skellysim_tpu_torch.obs``).

Counterpart of `skellysim_tpu.obs`; its cost and roofline legs (XLA cost
tables) and the benchmark's history gate are ROADMAP.md §1 item 14.
"""
