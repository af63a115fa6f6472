"""ParaView Programmable Source: velocity-field point cloud (RequestData body).

Use `field_reader_request.py` as the RequestInformation script. Reads frames
{time, dt, x_grid, v_grid} written by
`skellysim_tpu_torch.io.trajectory.FieldWriter` (or the
reference's `skelly_sim.vf.*` files). Mirrors the reference
`paraview_utils/field_reader.py`: points carry 'velocities' and 'magnitudes'
arrays.
"""

import vtk  # noqa: F401
from trajectory_utility import load_field_frame

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

frame = load_field_frame(self.fhs, self.fpos, timestep)  # noqa: F821

npts = int(sum(data["x_grid"][2] for data in frame))
pts = vtk.vtkPoints()

velocities = vtk.vtkDoubleArray()
velocities.SetName("velocities")
velocities.SetNumberOfComponents(3)
velocities.SetNumberOfTuples(npts)

magnitudes = vtk.vtkDoubleArray()
magnitudes.SetName("magnitudes")
magnitudes.SetNumberOfValues(npts)

offset = 0
for data in frame:
    n_local = data["x_grid"][2]
    x_grid = data["x_grid"][3:]
    v_grid = data["v_grid"][3:]
    for i in range(n_local):
        v = v_grid[3 * i:3 * (i + 1)]
        pts.InsertPoint(offset, x_grid[3 * i:3 * (i + 1)])
        velocities.SetTuple(offset, v)
        magnitudes.SetValue(offset, (v[0] ** 2 + v[1] ** 2 + v[2] ** 2) ** 0.5)
        offset += 1

pd = self.GetPolyDataOutput()  # noqa: F821
pd.SetPoints(pts)
pd.GetPointData().AddArray(velocities)
pd.GetPointData().AddArray(magnitudes)
