"""ParaView RequestInformation script for the fiber/body readers.

Indexes the trajectory in the working directory; single-file
(`skelly_sim.out`, as `python -m skellysim_tpu_torch` writes it) or the
reference's per-rank files
(`skelly_sim.out.*`).
"""

from pathlib import Path

import vtk  # noqa: F401
from trajectory_utility import get_frame_info

outInfo = self.GetOutputInformation(0)  # noqa: F821
files = (sorted(Path(".").glob("skelly_sim.out.*"))
         or [p for p in [Path("skelly_sim.out")] if p.exists()])
self.fhs, self.fpos, self.times = get_frame_info(files)  # noqa: F821
outInfo.Set(vtk.vtkStreamingDemandDrivenPipeline.TIME_RANGE(),
            [self.times[0], self.times[-1]], 2)  # noqa: F821
outInfo.Set(vtk.vtkStreamingDemandDrivenPipeline.TIME_STEPS(),
            self.times, len(self.times))  # noqa: F821
