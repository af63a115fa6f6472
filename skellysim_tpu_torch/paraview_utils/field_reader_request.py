"""ParaView RequestInformation script for the velocity-field reader."""

from pathlib import Path

import vtk  # noqa: F401
from trajectory_utility import get_frame_info

outInfo = self.GetOutputInformation(0)  # noqa: F821
files = (sorted(Path(".").glob("skelly_sim.vf.*"))
         or [p for p in [Path("skelly_sim.vf")] if p.exists()])
self.fhs, self.fpos, self.times = get_frame_info(files)  # noqa: F821
outInfo.Set(vtk.vtkStreamingDemandDrivenPipeline.TIME_RANGE(),
            [self.times[0], self.times[-1]], 2)  # noqa: F821
outInfo.Set(vtk.vtkStreamingDemandDrivenPipeline.TIME_STEPS(),
            self.times, len(self.times))  # noqa: F821
