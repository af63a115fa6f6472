"""ParaView Programmable Source: fibers as polylines (RequestData body).

Paste into a Programmable Source with `fiber_reader_request.py` as the
RequestInformation script; set `self.times/fhs/fpos` there. Mirrors the
reference `paraview_utils/fiber_reader.py`.
"""

import vtk  # noqa: F401  (provided by ParaView's Python)
from trajectory_utility import eigen_points, load_frame

outInfo = self.GetOutputInformation(0)  # noqa: F821 (ParaView binds `self`)

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

pts = vtk.vtkPoints()
lines = vtk.vtkCellArray()
offset = 0
for fib in frame["fibers"]:
    nodes = eigen_points(fib["x_"])
    lines.InsertNextCell(len(nodes))
    for node in nodes:
        lines.InsertCellPoint(offset)
        pts.InsertPoint(offset, node)
        offset += 1

pd = self.GetPolyDataOutput()  # noqa: F821
pd.SetPoints(pts)
pd.SetLines(lines)
