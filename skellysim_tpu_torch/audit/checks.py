"""The nine audit checks, on what one run of a program did.

Counterpart of `skellysim_tpu.audit.checks`, under its check ids and
contract sections. Each check is ``(program_name, run, contract, probe) ->
[Finding]``: over the program matrix ``run`` is an `engine.ProgramRun`
(the fixture run once under `observe.Observer`), over the kernel matrix a
`registry.BuiltKernel`. What a run shows is the fixture's behaviour on the
backend it ran on, not every input's (ROADMAP.md §3, differences by
design); `--dump-contract` prints the observed inventory in contract
syntax, the sanctioned way to update a contract after a deliberate
change.
"""

from __future__ import annotations

from dataclasses import dataclass

from .engine import Finding
from .observe import bit_equal

#: the host syncs' kinds as the contract names them: a read of device
#: values on the host (``.item()``, ``bool()``, ``.cpu()``, ``.tolist()``,
#: ``.numpy()``), an op that waits to size its output, a blocking upload,
#: a stream wait
SYNC_KINDS = {"item": "read", "d2h": "read", "numpy": "read",
              "tolist": "read", "sync-op": "sync-op", "upload": "upload",
              "synchronize": "wait"}
#: kinds that happen on the card only (their pins are the card's)
CARD_ONLY = ("upload", "wait")


#: a backend's own pins inside a section (``[host_sync.cuda]``,
#: ``[dtype.cpu.promotions]``): where the two backends cannot agree (the
#: plain twins of the kernels run on the CPU only, and a float32 Krylov
#: loop may take other iterations on the card), the contract says which
#: backend a pin is for
BACKENDS = ("cpu", "cuda")


def for_device(spec: dict, device) -> dict:
    """``spec`` with its ``device.type`` table laid over the common keys
    (a nested table replaced whole) and the backend tables dropped."""
    spec = spec or {}
    out = {k: v for k, v in spec.items() if k not in BACKENDS}
    kind = getattr(device, "type", None)
    out.update(spec.get(kind, {}))
    return out


def host_sync_observed(obs, device=None) -> dict:
    """The ``[host_sync]`` dict of an observation: ``allowed_callbacks``
    (the kinds of host round trip made), ``read_sites`` / ``read_events``
    (reads of device values), ``sync_op_sites`` and, on the card,
    ``upload_sites`` and ``wait_sites``."""
    sites, events = {}, {}
    for (kind, where), n in obs.host_syncs.items():
        k = SYNC_KINDS[kind]
        sites.setdefault(k, set()).add(where)
        events[k] = events.get(k, 0) + n
    out = {"allowed_callbacks": sorted(sites),
           "read_sites": len(sites.get("read", ())),
           "read_events": events.get("read", 0),
           "sync_op_sites": len(sites.get("sync-op", ()))}
    dev = obs.device if device is None else device
    if dev is not None and dev.type == "cuda":
        out["upload_sites"] = len(sites.get("upload", ()))
        out["wait_sites"] = len(sites.get("wait", ()))
    return out


def changed_arguments(run) -> list:
    """Paths of the arguments whose bits the call changed."""
    after = dict(run.after)
    return [p for p, v in run.before if not bit_equal(v, after.get(p))]


# ------------------------------------------------------------------ checks

def check_collective_contract(name, run, contract, probe):
    """Each kind's calls, sites and largest operand bytes a shard against
    ``[collectives.<kind>]`` (``count`` mandatory, ``sites`` and
    ``max_bytes`` / ``max_elems`` when pinned); an uncontracted kind and a
    stale entry are findings."""
    out = []
    cid = "collective-contract"
    want = dict(contract.get("collectives", {}))
    for kind, seen in run.observation.collective_table().items():
        spec = want.pop(kind, None)
        if spec is None:
            out.append(Finding(name, cid, (
                f"uncontracted collective: {seen['count']} {kind} call(s) "
                f"from {seen['sites']} site(s) but the contract has no "
                f"[collectives.{kind}] entry")))
            continue
        count = spec.get("count")
        if count is None:
            out.append(Finding(name, cid, (
                f"[collectives.{kind}] has no `count` pin — every "
                "contracted collective must pin its calls a run")))
        elif count != seen["count"]:
            out.append(Finding(name, cid, (
                f"{kind} count drifted: contract pins {count}, the run "
                f"made {seen['count']}")))
        if "sites" in spec and spec["sites"] != seen["sites"]:
            out.append(Finding(name, cid, (
                f"{kind} sites drifted: contract pins {spec['sites']}, the "
                f"run called it from {seen['sites']}")))
        max_bytes = spec.get("max_bytes")
        if max_bytes is not None and seen["max_bytes"] > max_bytes:
            out.append(Finding(name, cid, (
                f"{kind} moves {seen['max_bytes']} bytes a shard, over the "
                f"contract bound of {max_bytes} — an unexpected operand is "
                "crossing the mesh")))
    for kind, spec in sorted(want.items()):
        if spec.get("count", 1) != 0:
            out.append(Finding(name, cid, (
                f"stale contract: [collectives.{kind}] pins count="
                f"{spec.get('count')} but the run made none")))
    return out


def check_dtype_flow(name, run, contract, probe):
    """Float edges (``_to_copy`` / ``copy_`` between float dtypes, widening
    and narrowing) and mixed-precision ops, counted by site, against
    ``[dtype.promotions]`` and ``[dtype.mixed]`` (a backend's own tables
    under ``[dtype.cpu]`` / ``[dtype.cuda]``)."""
    out = []
    cid = "dtype-flow"
    obs = run.observation
    spec = for_device(contract.get("dtype", {}), obs.device)
    for table, seen, what in (
            ("promotions", obs.edge_sites(), "float edge"),
            ("mixed", obs.mixed_sites(), "mixed float32 / float64 op")):
        allowed = dict(spec.get(table, {}))
        for key, n in sorted(seen.items()):
            pinned = allowed.pop(key, None)
            if pinned is None:
                out.append(Finding(name, cid, (
                    f"{n} {key} {what} site(s) with no [dtype.{table}] "
                    "entry — a float changes width on the run's path (the "
                    "46b498b leak family)")))
            elif pinned != n:
                out.append(Finding(name, cid, (
                    f"{key} {what} sites drifted: contract pins {pinned}, "
                    f"the run has {n}")))
        for key, pinned in sorted(allowed.items()):
            out.append(Finding(name, cid, (
                f"stale contract: [dtype.{table}] pins {key} = {pinned} but "
                "the run has no such site")))
    return out


def check_host_sync(name, run, contract, probe):
    """Host round trips by kind and site against ``[host_sync]``: a kind
    not in ``allowed_callbacks`` is a finding, a listed kind the run never
    made is stale; ``read_sites``, ``read_events`` and ``sync_op_sites``
    gate on every device, ``upload_sites`` / ``wait_sites`` on the card
    (the CPU uploads nothing); a backend's own pins sit in
    ``[host_sync.cpu]`` / ``[host_sync.cuda]``."""
    out = []
    cid = "host-sync"
    obs = run.observation
    spec = for_device(contract.get("host_sync", {}), obs.device)
    seen = host_sync_observed(obs)
    on_card = obs.device is not None and obs.device.type == "cuda"
    allowed = set(spec.get("allowed_callbacks", []))
    for kind in seen["allowed_callbacks"]:
        if kind not in allowed:
            n = sum(v for (k, _), v in obs.host_syncs.items()
                    if SYNC_KINDS[k] == kind)
            out.append(Finding(name, cid, (
                f"{n} host {kind} event(s) in the run: each is a round "
                "trip to the host; remove it or allow it in the contract "
                "with a reason")))
    for kind in sorted(allowed - set(seen["allowed_callbacks"])):
        if kind in CARD_ONLY and not on_card:
            continue
        out.append(Finding(name, cid, (
            f"stale contract: host_sync allows {kind!r} but the run made "
            "none")))
    for key, value in seen.items():
        if key == "allowed_callbacks" or key not in spec:
            continue
        if spec[key] != value:
            out.append(Finding(name, cid, (
                f"{key} drifted: contract pins {spec[key]}, the run has "
                f"{value} — a host read was added to (or taken from) the "
                "program")))
    return out


def check_donation(name, run, contract, probe):
    """``donated = false``: every argument holds its bits after the call
    (what the rollback-safe trial needs); ``donated = true``: some
    argument was consumed. The port never aliases an argument into an
    output, so ``true`` with the arguments intact is the stale
    direction."""
    spec = contract.get("donation")
    if spec is None:
        return []
    cid = "donation"
    changed = changed_arguments(run)
    writes = sorted({w for _, w in run.observation.arg_writes})
    if spec.get("donated") and not changed:
        return [Finding(name, cid, (
            "contract says the input buffers are donated but every "
            "argument has its bits after the call — the step "
            "double-buffers what it claims to consume"))]
    if not spec.get("donated") and changed:
        return [Finding(name, cid, (
            f"contract says NO donation (rollback safety) but the call "
            f"changed {', '.join(changed[:4])}"
            + (f" (written at {', '.join(writes[:3])})" if writes else "")
            + " — a rejected step would roll back into consumed buffers"))]
    return []


def check_retrace_budget(name, run, contract, probe):
    """The registered probe's rebuilds (`registry.probe_twice`: CUDA
    libraries loaded, host plans, kept-geometry misses and the port's
    cached tables built by a second call of the same structure, plus one)
    against ``[retrace] max_traces``."""
    spec = contract.get("retrace")
    if spec is None:
        return []
    cid = "retrace-budget"
    if probe is None:
        return [Finding(name, cid, (
            "contract has a [retrace] budget but the program registers no "
            "retrace probe — drop the section or register one"))]
    budget = spec.get("max_traces", 1)
    traces = run.traces() if probe is run.prog.retrace_probe \
        else probe(run.device)
    if traces > budget:
        return [Finding(name, cid, (
            f"a same-structure second call rebuilt {traces - 1} thing(s) "
            f"(budget {budget} trace(s)): a library load, a host plan or a "
            "cached table depends on the call's values, paid on the hot "
            "path"))]
    return []


def check_fft_inventory(name, run, contract, probe):
    """FFT sites (aten ``_fft_*``) against ``[fft] count``."""
    out = []
    cid = "fft-inventory"
    obs = run.observation
    total = obs.fft_sites()
    kinds = {}
    for (op, _), _n in obs.ffts.items():
        kinds[op] = kinds.get(op, 0) + 1
    breakdown = ", ".join(f"{k} x{n}" for k, n in sorted(kinds.items()))
    spec = contract.get("fft")
    if spec is None:
        if total:
            out.append(Finding(name, cid, (
                f"{total} fft site(s) ({breakdown}) with no [fft] section "
                "— transforms are the spectral evaluator's cost centre; "
                "pin their count")))
        return out
    pinned = spec.get("count")
    if pinned is None:
        out.append(Finding(name, cid, (
            "[fft] has no `count` pin — a contracted fft inventory must "
            "pin its site count")))
    elif pinned != total:
        out.append(Finding(name, cid, (
            f"fft count drifted: contract pins {pinned}, the run has "
            f"{total} ({breakdown or 'none'}) — a per-component or per-axis "
            "re-transform crept in (or the contract is stale)")))
    return out


def check_replication(name, run, contract, probe):
    """`audit.repflow` on a sharded program's run: replicated outputs the
    same bits on every shard, every collective's result the same on every
    shard (the host's decisions), and the replicated / varying surface
    against ``[replication]``."""
    from . import repflow

    out = []
    cid = "replication"
    report = repflow.analyze(run)
    spec = contract.get("replication")
    if report is None:
        if spec is not None:
            out.append(Finding(name, cid, (
                "stale contract: a [replication] section is pinned but the "
                "program is not sharded")))
        return out
    out.extend(Finding(name, cid, m) for m in report.findings)
    observed = report.observed
    if spec is None:
        out.append(Finding(name, cid, (
            "sharded program with no [replication] section — pin "
            "mesh_axes / replicated_outputs / varying_outputs (run "
            "--dump-contract for the observed surface)")))
        return out
    if list(spec.get("mesh_axes", [])) != observed["mesh_axes"]:
        out.append(Finding(name, cid, (
            f"mesh axes drifted: contract pins {spec.get('mesh_axes')}, "
            f"the program shards over {observed['mesh_axes']}")))
    for key, what in (("replicated_outputs", "replicated"),
                      ("varying_outputs", "varying (sharded)")):
        pinned = spec.get(key)
        if pinned is None:
            out.append(Finding(name, cid, (
                f"[replication] has no `{key}` pin — the {what} output "
                "surface must pin its count")))
        elif pinned != observed[key]:
            out.append(Finding(name, cid, (
                f"{key} drifted: contract pins {pinned}, the run has "
                f"{observed[key]} — an output moved across the "
                "replicated / sharded boundary")))
    return out


def check_dma(name, built, contract, probe):
    """`audit.dmaflow` over one registered kernel family, on the card: its
    compiled functions' registers, shared bytes a block and spills (from
    the ``-Xptxas -v`` report) against the ``[dma]`` pins and the card's
    limits, and 20 back-to-back launches at a ragged shape giving the same
    bits each time and the plain version's result at its gate."""
    from . import dmaflow

    cid = "dma"
    report = dmaflow.analyze(built)
    out = [Finding(name, cid, m) for m in report.findings]
    spec = (contract or {}).get("dma")
    if spec is None:
        out.append(Finding(name, cid, (
            "[dma] contract section missing — pin the kernels' registers, "
            "shared bytes and spills (run `--dump-contract "
            f"{name}` on the card for the observed values)")))
        return out
    observed = report.observed
    for key in sorted(set(spec) | set(observed)):
        if key not in observed:
            out.append(Finding(name, cid, (
                f"stale pin `{key}`: the check no longer reports it")))
        elif key not in spec:
            out.append(Finding(name, cid, (
                f"[dma] has no `{key}` pin — the check reports "
                f"{observed[key]!r}; every inventory key must be pinned")))
        elif spec[key] != observed[key]:
            out.append(Finding(name, cid, (
                f"{key} drifted: contract pins {spec[key]!r}, the build "
                f"shows {observed[key]!r} — re-derive the contract "
                "deliberately")))
    return out


def check_mask(name, run, contract, probe):
    """`audit.maskflow`: the dead slots of every declared capacity axis
    poisoned, the live outputs the clean run's bits, every output's pad
    class against ``[mask.outputs]``. Over the kernel matrix only the
    declaration applies (``axes = []``): a kernel takes no padded operand
    from its caller (its wrapper pads the source slot itself, at 1e18 with
    zero payload, which the ``dma`` repeats run at a ragged shape)."""
    from . import maskflow

    out = []
    cid = "mask"
    spec = contract.get("mask")
    if spec is None:
        out.append(Finding(name, cid, (
            "no [mask] section — declare the program's padded-capacity "
            "axes (`axes = []` when nothing is padded) so the masking "
            "discipline is pinned, not assumed")))
        return out
    axes, problems = maskflow.axes_from_contract(spec, name)
    out.extend(Finding(name, cid, m) for m in problems)
    is_kernel = not hasattr(run, "observation")
    if is_kernel:
        if axes or spec.get("outputs"):
            out.append(Finding(name, cid, (
                "kernel contracts cannot declare mask axes or output pins — "
                "a kernel takes no padded operand from its caller")))
        return out
    pins = dict(spec.get("outputs", {}))
    if not axes:
        if pins:
            out.append(Finding(name, cid, (
                "stale [mask.outputs] table: no capacity axes are declared, "
                "so every output is trivially live-only — drop the pins or "
                "declare the axes")))
        return out
    report = run.mask_report()
    out.extend(Finding(name, cid, m) for m in report.findings)
    for path, cls in report.observed.items():
        pin = pins.pop(path, None)
        if pin is None:
            out.append(Finding(name, cid, (
                f"output '{path}' has no [mask.outputs] pin — every output "
                f"of a padded program must pin its pad class (observed: "
                f"{cls})")))
        elif pin not in maskflow.PAD_CLASSES:
            out.append(Finding(name, cid, (
                f"output '{path}' pins unknown pad class {pin!r} (known: "
                f"{', '.join(maskflow.PAD_CLASSES)})")))
        elif pin != cls:
            out.append(Finding(name, cid, (
                f"output '{path}' pad class drifted: contract pins {pin!r}, "
                f"the poisoned run shows {cls!r} — an output moved across "
                "the padded / live boundary")))
    for path, pin in sorted(pins.items()):
        out.append(Finding(name, cid, (
            f"stale pin: [mask.outputs] pins '{path}' = {pin!r} but the run "
            "has no such output")))
    return out


@dataclass(frozen=True)
class Check:
    id: str
    summary: str
    run: object  # callable(name, run, contract, probe) -> [Finding]
    #: needs the (possibly expensive) retrace probe
    wants_probe: bool = False
    #: runs over the kernel registry (`kernels.all_kernels`)
    over_kernels: bool = False
    #: runs over the program registry (`programs.all_programs`)
    over_programs: bool = True
    #: needs the card (over the kernel matrix: the kernels must launch)
    needs_card: bool = False


CHECKS = (
    Check("collective-contract",
          "Collectives seam inventory (kind / calls / sites / largest "
          "operand bytes a shard) of one run must match the contract",
          check_collective_contract),
    Check("dtype-flow",
          "float edges (_to_copy / copy_ between float dtypes) and mixed "
          "float32 / float64 ops, by call site, vs the contract",
          check_dtype_flow),
    Check("host-sync",
          "host round trips of one run (reads of device values, ops that "
          "wait to size their output, blocking uploads) by kind and site",
          check_host_sync),
    Check("donation",
          "the arguments' bits after the call match the contract's donated "
          "flag (false: the rollback-safe trial leaves them intact)",
          check_donation),
    Check("retrace-budget",
          "a same-structure second call rebuilds nothing (libraries, host "
          "plans, kept geometry, cached tables) within the contract budget",
          check_retrace_budget, wants_probe=True),
    Check("fft-inventory",
          "aten fft sites of one run vs the contract's [fft] count pin (the "
          "spectral evaluator's transform budget)",
          check_fft_inventory),
    Check("replication",
          "sharded step: replicated outputs and every collective's result "
          "the same bits on every shard (the host's decisions), and the "
          "replicated / varying surface",
          check_replication),
    Check("dma",
          "hand-written kernels on the card: registers, shared bytes and "
          "spills vs the pins and the card's limits, and 20 back-to-back "
          "launches at a ragged shape giving the same bits and the plain "
          "version's result (read-before-arrival / overwrite-in-flight)",
          check_dma, over_kernels=True, over_programs=False,
          needs_card=True),
    Check("mask",
          "dead capacity slots poisoned (NaN, +/-inf, other in-range "
          "integers): live outputs keep their bits, per-output pad-class "
          "pins (pad-escape, 0*inf multiplicative masking, unmasked "
          "reductions)",
          check_mask, over_kernels=True),
)
