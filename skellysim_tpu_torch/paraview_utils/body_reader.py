"""ParaView Programmable Source: bodies as sphere glyphs (RequestData body).

Use `fiber_reader_request.py` as the RequestInformation script. Mirrors the
reference `paraview_utils/body_reader.py`; body radii come from
`skelly_config.toml` next to the trajectory.
"""

import toml
import vtk  # noqa: F401
from trajectory_utility import load_frame

toml_file = "skelly_config.toml"

outInfo = self.GetOutputInformation(0)  # noqa: F821

if outInfo.Has(vtk.vtkStreamingDemandDrivenPipeline.UPDATE_TIME_STEP()):
    time = outInfo.Get(vtk.vtkStreamingDemandDrivenPipeline.UPDATE_TIME_STEP())
else:
    time = 0

timestep = len(self.times) - 1  # noqa: F821
for i in range(len(self.times) - 1):  # noqa: F821
    if self.times[i] <= time < self.times[i + 1]:  # noqa: F821
        timestep = i
        break

frame = load_frame(self.fhs, self.fpos, timestep)  # noqa: F821

with open(toml_file) as f:
    skelly_config = toml.load(f)

mb = vtk.vtkMultiBlockDataSet()
for i, body in enumerate(frame["bodies"]):
    position = body["position_"][3:]  # ['__eigen__', 3, 1, x, y, z]
    s = vtk.vtkSphereSource()
    s.SetRadius(skelly_config["bodies"][i]["radius"])
    s.SetCenter(position)
    s.SetThetaResolution(32)
    s.SetPhiResolution(32)
    s.Update()
    mb.SetBlock(i, s.GetOutput())

self.GetOutput().ShallowCopy(mb)  # noqa: F821
