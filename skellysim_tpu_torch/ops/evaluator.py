"""PairEvaluator: a fast pair-evaluator plan, as every flow receives it.

Counterpart of `skellysim_tpu.ops.evaluator`. The runtime evaluator names
and their aliases live here, the single source for `System` and the
config schema. A fast evaluator's plan is built once a solve
(`System._pair_args`) and handed, as one `PairEvaluator`, to every flow
call site that may sum through it: the fiber flow
(`fibers.container.flow_multi`), the shell's double layer
(`periphery.flow`) and the body's (`bodies.flow`). The dense and ring
evaluators need no plan and are chosen by those flows' ``evaluator``
argument.

A tree plan's evaluator also keeps the tree's geometry (the sort, the
lists, the anterpolation weights) of each call site's positions, so the
matvecs of one solve build it once (`ops.treecode._tree_sum`). A flow takes
its call site's view of the step's evaluator (`PairEvaluator.at`: the
fiber flow, the shell's, a body bucket's by index, a shard's): the same
plan, anchors and kept geometry, the site part of the geometry's key.

``plan`` is an `ops.ewald.EwaldPlan` (free space), an
`ops.treecode.TreePlan` (free space) or an `ops.spectral.SpectralPlan`
(periodic boxes and slabs); `plan_module` dispatches to the module that
owns it, and any other plan type raises `TypeError`. Each module names its
plan's anchor fields (``ANCHORS``: the Ewald and spectral plans'
``box_lo`` and ``cell_lo``, the tree's ``box_lo``), the row its fill
positions are placed from (``FILL_ANCHOR``), and sums at the viscosity it
is given.
"""

from __future__ import annotations

import dataclasses
import types
from dataclasses import dataclass, field

import torch

from . import kernels

#: runtime evaluator names, the single source for validation (System, the
#: config schema)
EVALUATORS = ("direct", "ring", "ewald", "tree", "spectral")

#: accepted spellings -> runtime evaluator names: the reference's names
#: ("CPU"/"GPU"/"TPU" = dense direct, "FMM" = the free-space fast slot ->
#: Ewald, "PVFMM" = the periodic backend -> spectral Ewald) plus the native
#: names; looked up case-insensitively. Read-only, as every importer binds
#: the same object.
EVALUATOR_ALIASES = types.MappingProxyType(
    {"cpu": "direct", "gpu": "direct", "tpu": "direct",
     "fmm": "ewald",
     "pvfmm": "spectral",
     "direct": "direct", "ring": "ring", "ewald": "ewald",
     "tree": "tree", "spectral": "spectral"})


def plan_module(plan):
    """The ops module owning ``plan`` (imported lazily: the planners
    import this module)."""
    from . import ewald, spectral, treecode

    if isinstance(plan, ewald.EwaldPlan):
        return ewald
    if isinstance(plan, treecode.TreePlan):
        return treecode
    if isinstance(plan, spectral.SpectralPlan):
        return spectral
    raise TypeError(f"unknown pair-evaluator plan type {type(plan)!r}")


@dataclass(frozen=True, eq=False)
class PairEvaluator:
    """A fast plan and its anchors (one row a field of the module's
    ``ANCHORS``) as a float64 tensor on the device of the sums, made once
    by `make_pair`. Its sums are those of the plan's module at viscosity
    ``eta``; a plan that is the dense sum itself (a depth-0 tree) takes the
    dense seam (`ops.kernels`) at the calling flow's ``impl``, as in the
    JAX package."""

    plan: object
    anchors: torch.Tensor
    #: a tree plan's `ops.treecode.TreeGeometry` by (call site, family,
    #: dtype, sources, targets), built at the first sum over them and kept
    #: for the evaluator's life (one step: `System._pair_args`); every
    #: view made by `at` shares it
    geometry: dict = field(default_factory=dict, repr=False)
    #: the call site this view sums for (`at`), the first part of the kept
    #: geometry's key: counts alone never decide it
    site: tuple = ()

    def at(self, *site) -> "PairEvaluator":
        """This evaluator at call site ``site`` (e.g. ``("body", 1)``, or
        ``("fibers", "shard", 2)``): the same plan, anchors and kept
        geometry, with ``site`` appended to the view's own. Two sites with
        the same counts but other positions (two body buckets of one node
        total, two shards' targets) keep a geometry each."""
        return dataclasses.replace(self, site=self.site + tuple(site))

    def to(self, device) -> "PairEvaluator":
        """This view with its anchors on ``device`` (a shard's card), the
        kept geometry shared."""
        if self.anchors.device == torch.device(device):
            return self
        return dataclasses.replace(self, anchors=self.anchors.to(device))

    @property
    def evaluator(self) -> str:
        """The runtime evaluator name: "ewald", "tree" or "spectral"."""
        return plan_module(self.plan).EVALUATOR

    @property
    def dense(self) -> bool:
        """True when the plan is the dense sum (a depth-0 tree)."""
        return self.evaluator == "tree" and self.plan.depth == 0

    def fill_positions(self, n: int, dtype):
        """[n, 3] spread positions for zero-strength (inactive) sources."""
        mod = plan_module(self.plan)
        return mod.fill_positions(self.plan, self.anchors[mod.FILL_ANCHOR],
                                  n, dtype)

    def stokeslet(self, r_src, r_trg, f_src, n_self: int, eta,
                  impl: str = "exact"):
        """The singular Stokeslet sum (`kernels.stokeslet_direct`
        semantics; the first ``n_self`` targets are the sources)."""
        if self.dense:
            return kernels.stokeslet_direct(r_src, r_trg, f_src, eta,
                                            impl=impl)
        return plan_module(self.plan).stokeslet_impl(
            self.plan, self.anchors, r_src, r_trg, f_src, n_self, eta,
            **self._kept())

    def stresslet(self, r_dl, r_trg, f_dl, eta, impl: str = "exact"):
        """The singular stresslet (double-layer) sum, ``f_dl`` [n, 3, 3]."""
        if self.dense:
            return kernels.stresslet_direct(r_dl, r_trg, f_dl, eta,
                                            impl=impl)
        return plan_module(self.plan).stresslet_impl(
            self.plan, self.anchors, r_dl, r_trg, f_dl, eta, **self._kept())

    def _kept(self) -> dict:
        """What a sum may keep on this evaluator: a tree's geometry, under
        this view's call site."""
        if self.evaluator != "tree":
            return {}
        return {"geometry": self.geometry, "site": self.site}


def make_pair(plan, device) -> PairEvaluator:
    """The `PairEvaluator` of ``plan`` with its anchors on ``device``."""
    mod = plan_module(plan)
    return PairEvaluator(plan, torch.tensor(
        [getattr(plan, a) for a in mod.ANCHORS], dtype=torch.float64,
        device=device))
