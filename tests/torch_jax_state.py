"""Carry a JAX package state or system over to the port, for the port's
tests (not collected by pytest): numpy leaves through `convert`, runtime
node matrices and node-masked shells included."""

import dataclasses

import numpy as np

from skellysim_tpu.fibers import container as jfc
from skellysim_tpu_torch import convert
from skellysim_tpu_torch.periphery import periphery as tperi
from skellysim_tpu_torch.system import System


def leaves(nt):
    """numpy leaves of a JAX NamedTuple; ``rt_mats`` as a mapping of its
    own leaves."""
    out = {}
    for k, v in nt._asdict().items():
        if v is None:
            out[k] = None
        elif k == "rt_mats":
            out[k] = {kk: np.asarray(vv) for kk, vv in v._asdict().items()}
        else:
            out[k] = np.asarray(v)
    return out


def port_state(jstate, device="cpu"):
    """The port's `SimState` of a JAX `SimState` (fibers, shell, bodies,
    points, background; time and dt as floats)."""
    fib = jstate.fibers
    if fib is None:
        fibers = None
    elif isinstance(fib, jfc.FiberGroup):
        fibers = leaves(fib)
    else:
        fibers = [leaves(g) for g in fib]
    bodies = jstate.bodies
    if bodies is not None:
        bodies = (leaves(bodies) if hasattr(bodies, "_fields")
                  else [leaves(g) for g in bodies])
    return convert.state_from_numpy(
        fibers, time=float(jstate.time), dt=float(jstate.dt),
        points=None if jstate.points is None else leaves(jstate.points),
        background=(None if jstate.background is None
                    else leaves(jstate.background)),
        shell=None if jstate.shell is None else leaves(jstate.shell),
        bodies=bodies, device=device)


def port_system(jsys, device="cpu"):
    """The port's `System` with the JAX system's params and shell shape."""
    shape = jsys.shell_shape
    return System(convert.params_from_dict(dataclasses.asdict(jsys.params)),
                  shell_shape=(None if shape is None else tperi.PeripheryShape(
                      **dataclasses.asdict(shape))), device=device)
