"""ParaView programmable-source readers for skellysim_tpu_torch trajectories.

The port's own copy of the JAX package's `paraview_utils/`, itself a mirror
of the reference toolkit (`src/skelly_sim/paraview_utils/`):
each `*_reader.py` is the RequestData body of a ParaView Programmable Source
and each `*_reader_request.py` its RequestInformation script;
`trajectory_utility.py` is the standalone frame indexer/loader they share
(standalone because ParaView executes these scripts outside this package:
they import `vtk` and `trajectory_utility`, nothing of either package).
The trajectory format is byte-compatible with the reference, so these readers
work on reference trajectories too (and vice versa).
"""
