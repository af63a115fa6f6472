"""The wire protocol the listener speaks (`serve.protocol`).

Counterpart of `skellysim_tpu.serve`; of it the port carries the framing
and the request schema so far (the simulation service is ROADMAP.md §1).
"""
