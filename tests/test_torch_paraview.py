"""The port's ParaView readers, `FieldWriter` and the deformable stub
against the JAX package's.

* `io.trajectory.FieldWriter` writes the JAX `FieldWriter`'s file byte for
  byte: numpy inputs, float64 and float32 tensors, appended frames;
* the port's `paraview_utils/trajectory_utility.py`, exec'd standalone as
  ParaView would (`tests/test_paraview_utils.py`'s way), gives the JAX
  copy's `get_frame_info` / `load_frame` / `load_field_frame` results on a
  trajectory the port's CLI wrote (one 16-node fiber, 3 frames, on the
  CPU) and on the field file;
* the reader scripts import `vtk`, `trajectory_utility` and the standard
  library only (ParaView runs them outside either package);
* the deformable body: the port's builder raises the JAX stub's class
  name and message, word for word.
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from skellysim_tpu.io.trajectory import FieldWriter as JFieldWriter
from skellysim_tpu_torch.io.trajectory import FieldWriter

REPO = Path(__file__).resolve().parent.parent
PORT_UTILS = REPO / "skellysim_tpu_torch" / "paraview_utils"
JAX_UTILS = REPO / "skellysim_tpu" / "paraview_utils"


def _load_utility(folder):
    spec = importlib.util.spec_from_file_location(
        "trajectory_utility", folder / "trajectory_utility.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)   # standalone, like ParaView would exec it
    return mod


def _field(seed=3, n=50):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((n, 3)), rng.standard_normal((n, 3))


@pytest.mark.parametrize("kind", ["numpy", "float64", "float32"])
def test_field_writer_bytes_equal_jax(tmp_path, kind):
    x, v = _field()
    if kind == "float32":
        x, v = x.astype(np.float32), v.astype(np.float32)
    tx, tv = ((x, v) if kind == "numpy"
              else (torch.as_tensor(x), torch.as_tensor(v)))
    a, b = tmp_path / "port.vf", tmp_path / "jax.vf"
    with FieldWriter(str(a)) as fw:
        fw.write_frame(0.0, tx, tv)
        fw.write_frame(0.5, tx + 1, tv, dt=0.25)
    with FieldWriter(str(a), append=True) as fw:
        fw.write_frame(1.0, tx.reshape(-1), tv.reshape(-1))
    with JFieldWriter(str(b)) as fw:
        fw.write_frame(0.0, x, v)
        fw.write_frame(0.5, x + 1, v, dt=0.25)
    with JFieldWriter(str(b), append=True) as fw:
        fw.write_frame(1.0, x.reshape(-1), v.reshape(-1))
    assert a.read_bytes() == b.read_bytes()


def _write_sim(tmp_path):
    """The port's CLI on `tests/test_paraview_utils.py`'s scene: one
    16-node fiber advected by a uniform background, 3 frames."""
    from skellysim_tpu_torch import cli
    from skellysim_tpu_torch.config import BackgroundSource, Config, Fiber

    cfg = Config()
    cfg.params.dt_initial = 0.005
    cfg.params.dt_write = 0.005
    cfg.params.t_final = 0.01
    cfg.params.adaptive_timestep_flag = False
    fib = Fiber(n_nodes=16, length=1.0, bending_rigidity=0.01)
    fib.fill_node_positions(np.zeros(3), np.array([0.0, 0.0, 1.0]))
    cfg.fibers = [fib]
    cfg.background = BackgroundSource(uniform=[1.0, 0.0, 0.0])
    path = str(tmp_path / "skelly_config.toml")
    cfg.save(path)
    cli.run(path, device="cpu")
    return str(tmp_path / "skelly_sim.out")


def _close(fhs):
    for fh in fhs:
        fh.close()


def test_trajectory_utility_matches_jax_on_a_port_trajectory(tmp_path):
    traj = _write_sim(tmp_path)
    port, jax_u = _load_utility(PORT_UTILS), _load_utility(JAX_UTILS)
    got, ref = port.get_frame_info([traj]), jax_u.get_frame_info([traj])
    assert got[1:] == ref[1:]
    times = got[2]
    assert len(times) == 3 and times == sorted(times)
    for i in range(len(times)):
        frame = port.load_frame(got[0], got[1], i)
        assert frame == jax_u.load_frame(ref[0], ref[1], i)
        assert frame["time"] == times[i] and len(frame["fibers"]) == 1
    pts = port.eigen_points(frame["fibers"][0]["x_"])
    assert pts == jax_u.eigen_points(frame["fibers"][0]["x_"])
    assert len(pts) == 16 and pts[0][0] > 0.0   # advected along +x
    _close(got[0] + ref[0])


def test_trajectory_utility_reads_the_port_field_file(tmp_path):
    x, v = _field(n=20)
    path = str(tmp_path / "skelly_sim.vf")
    with FieldWriter(path) as fw:
        fw.write_frame(0.0, torch.as_tensor(x), torch.as_tensor(v))
        fw.write_frame(1.0, torch.as_tensor(x + 1), torch.as_tensor(v))
    port, jax_u = _load_utility(PORT_UTILS), _load_utility(JAX_UTILS)
    got, ref = port.get_frame_info([path]), jax_u.get_frame_info([path])
    assert got[1:] == ref[1:] and got[2] == [0.0, 1.0]
    frames = port.load_field_frame(got[0], got[1], 1)
    assert frames == jax_u.load_field_frame(ref[0], ref[1], 1)
    assert frames[0]["x_grid"][:3] == ["__eigen__", 3, 20]
    np.testing.assert_array_equal(frames[0]["x_grid"][3:], (x + 1).ravel())
    np.testing.assert_array_equal(frames[0]["v_grid"][3:], v.ravel())
    _close(got[0] + ref[0])


def _imports(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield (node.module or "").split(".")[0]


def test_reader_scripts_import_no_package():
    names = sorted(p.name for p in PORT_UTILS.glob("*.py"))
    assert names == sorted(p.name for p in JAX_UTILS.glob("*.py"))
    assert len(names) == 7
    allowed = {"vtk", "trajectory_utility", "msgpack", "toml", "pathlib"}
    for name in names:
        assert set(_imports(PORT_UTILS / name)) <= allowed, name


def test_deformable_stub_message_equals_jax(tmp_path):
    from skellysim_tpu.bodies import deformable as jdef
    from skellysim_tpu_torch import builder
    from skellysim_tpu_torch.bodies import deformable as tdef
    from skellysim_tpu_torch.config import Body

    with pytest.raises(jdef.DeformableBodyNotImplemented) as ref:
        jdef.make_group()
    with pytest.raises(tdef.DeformableBodyNotImplemented) as got:
        builder.build_bodies([Body(shape="deformable")], str(tmp_path),
                             torch.float64, "cpu")
    assert str(got.value) == str(ref.value)
    assert issubclass(tdef.DeformableBodyNotImplemented, NotImplementedError)
    assert tdef.SOLUTION_PER_NODE == jdef.SOLUTION_PER_NODE == 4
