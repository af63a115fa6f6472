"""Precompute console: periphery + body quadrature/operator npz generation.

Counterpart of `skellysim_tpu.precompute`: reads the TOML config, builds
every body's quadrature npz and the periphery's dense operator npz (the JAX
package's keys, so either package's builder reads them), and — for
surfaces of revolution — rewrites the config with the node count the
envelope discretization chose.

Usage: python -m skellysim_tpu_torch.precompute [skelly_config.toml]
       [--device=cuda|cpu]

The shell operator is assembled in float64 and inverted on the card by
default, with the inverse stored in float32; ``--device=cpu`` assembles and
inverts it on the host in float64 (scipy), as the JAX package's default
precompute does. Quadrature always runs on the host.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .config import schema
from .periphery.precompute import precompute_body, precompute_periphery


def precompute_from_config(config_file: str, verbose: bool = True,
                           device=None) -> dict:
    """Write the config's precompute files, the shell operator's on
    ``device`` (None = the card; see `precompute_periphery`); returns the
    periphery's stats (seconds of quadrature / assembly / inverse and the
    inverse check), empty without a periphery."""
    config = schema.load_config(config_file)
    config_dir = os.path.dirname(os.path.abspath(config_file)) or "."

    done: set[str] = set()
    for body in config.bodies:
        path = os.path.join(config_dir, body.precompute_file)
        if path in done:
            continue
        if verbose:
            print(f"Precomputing body ({body.shape}, n={body.n_nodes}) "
                  f"-> {body.precompute_file}")
        a, b, c = body.axis_length
        np.savez(path, **precompute_body(body.shape.lower(), body.n_nodes,
                                         radius=body.radius, a=a, b=b, c=c))
        done.add(path)

    stats: dict = {}
    periphery = getattr(config, "periphery", None)
    if periphery is None:
        return stats
    kw: dict = {"eta": config.params.eta}
    if periphery.shape == "sphere":
        kw["radius"] = periphery.radius
    elif periphery.shape == "ellipsoid":
        kw.update(a=periphery.a, b=periphery.b, c=periphery.c)
    elif periphery.shape == "surface_of_revolution":
        kw["envelope"] = dict(periphery.envelope)
    if verbose:
        print(f"Precomputing periphery ({periphery.shape}, "
              f"n={periphery.n_nodes}) -> {periphery.precompute_file}")
    data = precompute_periphery(periphery.shape, periphery.n_nodes,
                                device=device, stats=stats, **kw)
    np.savez(os.path.join(config_dir, periphery.precompute_file), **data)
    if verbose:
        print("Periphery: " + ", ".join(
            f"{k} {v:.4g}" if isinstance(v, float) else f"{k} {v}"
            for k, v in stats.items()))

    n_actual = data["nodes"].shape[0]
    if n_actual != periphery.n_nodes:
        # the envelope discretization picks the real node count; write it
        # back so the runtime sees consistent sizes
        if verbose:
            print(f"Updating config n_nodes: {periphery.n_nodes} -> "
                  f"{n_actual}")
        periphery.n_nodes = n_actual
        config.save(config_file)
    return stats


def main(argv=None) -> dict:
    """The CLI; returns the periphery's stats (see
    `precompute_from_config`)."""
    ap = argparse.ArgumentParser(
        prog="skellysim-tpu-torch-precompute",
        description="Generate periphery/body precompute npz files for a "
                    "config")
    ap.add_argument("config_file", nargs="?", default="skelly_config.toml")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="where the shell operator is assembled and "
                         "inverted: the CUDA card (default; float32 "
                         "inverse, raises when there is none) or the host "
                         "CPU (float64, scipy)")
    args = ap.parse_args(argv)
    return precompute_from_config(args.config_file, device=args.device)


if __name__ == "__main__":
    main()
