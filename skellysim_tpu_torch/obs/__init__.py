"""Runtime observation: the physics flight recorder (`obs.flight`).

Counterpart of `skellysim_tpu.obs`; of it the port carries the flight
recorder so far (the tracer, the profile and cost legs and the obs CLI
are ROADMAP.md §1 item 14).
"""
