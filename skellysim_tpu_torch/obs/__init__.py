"""Runtime observation: the physics flight recorder (`obs.flight`), the
span tracer (`obs.tracer`), the latency histograms (`obs.hist`) and the
report fold (`obs.summarize`).

Counterpart of `skellysim_tpu.obs`; the profile and cost legs, the
timeline and the obs CLI are ROADMAP.md §1 item 14.
"""
