"""The masking discipline, checked on a run: padded capacity slots must not
reach live physics.

Runtime twin of `skellysim_tpu.audit.maskflow`, which proves it statically
by a taint analysis over the jaxpr. The contract declares the program's
capacity masks the JAX package's way (``[[mask.axes]]``: ``name``, the
boolean ``mask`` input path such as ``"0.fibers.active"``, the ``scope``
of input leaves it guards and the ``dim`` of the slot axis); a run
checks what the analysis proves:

1. the fixture is built with dead slots (`with_dead_slots`: the second
   half of the mask's slots turned off where the fixture has none, as the
   JAX contracts' fixture pads 2 live fibers to 4) and run clean;
2. it runs again with every dead slot of every leaf in the scope
   poisoned (`poison`): floats NaN in one run and alternating +inf / -inf
   in another (``0 * inf`` is NaN: a multiplicative mask shows there),
   booleans flipped, integers given other values from the leaf's own
   range, so a poisoned index points somewhere valid and does not merely
   raise;
3. every output leaf is compared with the clean run's, bit for bit.

An output whose live entries change is a ``pad-escape`` finding, as is a
poisoned run that raises. Each output is classified (the JAX
``[mask.outputs]`` vocabulary) over the slots the mask marks dead in the
input:

    pad-passthrough   the dead slots carry the input's garbage (or
                      something made from it) through
    pad-exact-zero    the dead slots are exact zeros in every run (the
                      mask leaf itself: dead slots stay off)
    live-only         the dead slots, or the whole leaf where it has no
                      slot axis, hold the same bits in every run

A run shows the fixture, not every input: a leak that this fixture's
values do not trigger stays unseen, where the static analysis would flag
the site. Outputs without a slot axis are compared whole.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from .observe import bit_equal, flatten

PAD_PASSTHROUGH = "pad-passthrough"
PAD_EXACT_ZERO = "pad-exact-zero"
LIVE_ONLY = "live-only"
PAD_CLASSES = (PAD_EXACT_ZERO, PAD_PASSTHROUGH, LIVE_ONLY)

#: the poisoned runs: dead float slots get NaN, or +inf / -inf alternately
POISONS = ("nan", "inf")


@dataclass(frozen=True)
class MaskAxis:
    name: str
    mask: str           # input path of the boolean live mask
    scope: str | None   # input path prefix of the leaves it guards
    dim: int = 0        # the slot axis of the guarded leaves (and the mask)


def axes_from_contract(spec, name):
    """([MaskAxis], [(message)]) from a contract's ``[mask]`` section: each
    ``[[mask.axes]]`` entry needs a ``name`` and a ``mask``; names are
    unique."""
    axes, problems, seen = [], [], set()
    for i, e in enumerate((spec or {}).get("axes", [])):
        ax_name, mask = e.get("name"), e.get("mask")
        if not ax_name or not mask:
            problems.append(
                f"[[mask.axes]] entry #{i + 1} needs both `name` and `mask` "
                "(the boolean live-mask input path)")
            continue
        if ax_name in seen:
            problems.append(
                f"duplicate mask axis name {ax_name!r} — each capacity axis "
                "declares exactly once")
            continue
        seen.add(ax_name)
        axes.append(MaskAxis(name=ax_name, mask=mask, scope=e.get("scope"),
                             dim=int(e.get("dim", 0))))
    return axes, problems


# ------------------------------------------------------------ the paths

def get_path(obj, path: str):
    for part in path.split("."):
        if isinstance(obj, tuple) and hasattr(obj, "_fields") \
                and part in obj._fields:
            obj = getattr(obj, part)
        elif isinstance(obj, (tuple, list)):
            obj = obj[int(part)]
        elif isinstance(obj, dict):
            obj = obj[part]
        else:
            raise KeyError(path)
    return obj


def replace_paths(obj, new: dict, prefix: str = ""):
    """``obj`` with the leaves at the paths of ``new`` replaced (named
    tuples, tuples, lists and dicts rebuilt; everything else shared)."""
    if prefix in new:
        return new[prefix]
    if not any(p.startswith(prefix) for p in new):
        return obj

    def sub(p):
        return f"{prefix}.{p}" if prefix else str(p)

    if isinstance(obj, tuple) and hasattr(obj, "_fields"):
        return obj._replace(**{f: replace_paths(getattr(obj, f), new, sub(f))
                               for f in obj._fields})
    if isinstance(obj, (tuple, list)):
        return type(obj)(replace_paths(v, new, sub(i))
                         for i, v in enumerate(obj))
    if isinstance(obj, dict):
        return {k: replace_paths(v, new, sub(k)) for k, v in obj.items()}
    return obj


def _dead(mask, leaf, dim):
    """The dead-slot selector of ``leaf`` (bool, broadcast over its
    trailing dims) when its leading dims are the mask's, else None."""
    if not isinstance(leaf, torch.Tensor) or mask.ndim != dim + 1:
        return None
    if tuple(leaf.shape[:mask.ndim]) != tuple(mask.shape):
        return None
    dead = ~mask.to(leaf.device)
    return dead.reshape(tuple(dead.shape) + (1,) * (leaf.ndim - dead.ndim))


def with_dead_slots(args, axes):
    """``args`` with dead slots on every mask axis: a mask with none gets
    its second half of slots (along its last dim) turned off; a mask with
    some is kept."""
    new = {}
    for ax in axes:
        mask = get_path(args, ax.mask)
        if not bool((~mask).any()):
            m = mask.clone()
            n = m.shape[-1]
            m[..., n - n // 2:] = False
            new[ax.mask] = m
    return replace_paths(args, new) if new else args


def _guarded(args, ax):
    """[(path, leaf, dead selector)] of the input leaves ``ax`` guards."""
    mask = get_path(args, ax.mask)
    out = []
    for path, leaf in flatten(args):
        if path == ax.mask:
            continue
        if ax.scope and not (path == ax.scope
                             or path.startswith(ax.scope + ".")):
            continue
        dead = _dead(mask, leaf, ax.dim)
        if dead is not None:
            out.append((path, leaf, dead))
    return out


def _poisoned(leaf, dead, kind):
    if leaf.is_floating_point():
        if kind == "nan":
            bad = torch.full_like(leaf, float("nan"))
        else:
            sign = torch.ones_like(leaf).flatten()
            sign[1::2] = -1.0
            bad = sign.reshape(leaf.shape) * float("inf")
        return torch.where(dead, bad, leaf)
    if leaf.dtype == torch.bool:
        return torch.where(dead, ~leaf, leaf)
    # integers: other values of the leaf's own range (an index stays valid)
    lo, hi = int(leaf.min()), int(leaf.max())
    if lo == hi:
        return leaf
    other = torch.where(leaf == lo, torch.full_like(leaf, hi),
                        torch.full_like(leaf, lo))
    return torch.where(dead, other, leaf)


def poison(args, axes, kind: str):
    """``args`` with the dead slots of every leaf each axis guards
    poisoned (``kind``: "nan" or "inf"); returns (args, {path: poisoned
    leaf})."""
    new = {}
    for ax in axes:
        for path, leaf, dead in _guarded(args, ax):
            new[path] = _poisoned(new.get(path, leaf), dead, kind)
    return replace_paths(args, new), new


# -------------------------------------------------------------- classify

@dataclass
class MaskReport:
    observed: dict      # output path -> pad class
    findings: list      # messages


def _region_equal(a, b, sel):
    """Bits of ``a`` and ``b`` equal where ``sel`` (broadcast) is True."""
    sel = sel.expand_as(a)
    return bit_equal(a[sel], b[sel])


def _zero(t, sel):
    sel = sel.expand_as(t)
    v = t[sel]
    return v.numel() == 0 or not bool((v != 0).any())


def analyze(run) -> MaskReport:
    """Poison the dead slots of ``run`` (an `engine.ProgramRun` with its
    mask axes) and classify every output against the clean run."""
    if not run.axes:
        return MaskReport({}, [])
    findings = []
    clean_in = dict(run.before)
    clean_out = flatten(run.out)
    masks = {ax.mask: get_path(run.args, ax.mask) for ax in run.axes}
    dead_of = {}        # input path -> (dead selector, axis)
    for ax in run.axes:
        for path, _, dead in _guarded(run.args, ax):
            dead_of[path] = (dead, ax)
        dead_of[ax.mask] = (_dead(masks[ax.mask], masks[ax.mask], ax.dim),
                            ax)
    runs = {}
    for kind in POISONS:
        bad_args, _ = poison(run.args, run.axes, kind)
        try:
            out = run.rerun(bad_args)
        except Exception as e:
            findings.append(
                f"pad-escape: the run with the dead slots poisoned ({kind}) "
                f"raised {type(e).__name__}: {e}")
            return MaskReport({}, findings)
        runs[kind] = (dict(flatten(bad_args)), dict(flatten(out)))

    observed = {}
    for path, leaf in clean_out:
        sel = dead_of.get(path)
        if (sel is not None and isinstance(leaf, torch.Tensor)
                and leaf.shape == clean_in[path].shape):
            dead = sel[0]
            live = ~dead
            cls = None
            for kind, (bad_in, bad_out) in runs.items():
                other = bad_out.get(path)
                if not isinstance(other, torch.Tensor) \
                        or other.shape != leaf.shape:
                    findings.append(f"pad-escape: output '{path}' changed "
                                    f"shape with the dead slots poisoned "
                                    f"({kind})")
                    cls = "escaped"
                    break
                if not _region_equal(leaf, other, live):
                    findings.append(
                        f"pad-escape: output '{path}' changed at live "
                        f"entries with the dead slots of axis "
                        f"'{sel[1].name}' poisoned ({kind})")
                    cls = "escaped"
            if cls is None:
                cls = _classify(path, leaf, clean_in[path], runs, dead,
                                path == sel[1].mask)
            observed[path] = cls
        else:
            same = True
            for kind, (_, bad_out) in runs.items():
                if not bit_equal(leaf, bad_out.get(path)):
                    findings.append(
                        f"pad-escape: output '{path}' changed with the dead "
                        f"slots poisoned ({kind})")
                    same = False
            observed[path] = LIVE_ONLY if same else "escaped"
    return MaskReport(observed, findings)


def _classify(path, out, inp, runs, dead, is_mask) -> str:
    bad = [(runs[k][0].get(path, inp), runs[k][1][path]) for k in runs]
    zero = _zero(out, dead) and all(_zero(o, dead) for _, o in bad)
    if is_mask and zero:
        return PAD_EXACT_ZERO
    if _region_equal(out, inp, dead) and all(
            _region_equal(o, i, dead) for i, o in bad):
        return PAD_PASSTHROUGH
    if zero:
        return PAD_EXACT_ZERO
    if any(not _region_equal(out, o, dead) for _, o in bad):
        return PAD_PASSTHROUGH
    return LIVE_ONLY
