"""The numbers that decide `correct`, and their judgement against the
configuration's limits.

Training: the first three steps of the timed path, against the plain
reference run from the same weights, batches and draws:
- `loss_gap`: the largest |loss - reference loss| / |reference loss| over the
  three steps' D and G losses; `first_loss_gap` the same of the first step's;
- `grad_gap`: the first gradient as each optimizer took it (from its first
  moment after one step), leaf by leaf: the largest gap between the
  program's norm and the reference's, over the reference's norm of that leaf
  or of the median leaf, whichever is larger; `grad_median_gap` the median
  leaf's gap, steady from seed to seed;
- `change_gap`: the same of each parameter's change after three steps, and of
  the generator's EMA; `change_median_gap` the median leaf's. Leaves whose reference gradient is under a thousandth
  of the median leaf's (nought to rounding: a bias before BatchNorm, which
  Adam moves by round-off alone) are left out of the change.
Serving: the served uint8 videos of a sample of requests against the
reference's: `video_gap`, the mean |difference| in levels over every pixel,
and `worst_video_gap`, the largest of the per-video means.
"""

import numpy as np

DEAD_LEAF = 1e-3


def _median(values):
    return float(np.median(np.asarray(list(values), dtype=np.float64)))


def leaf_gap(program: dict, reference: dict, names) -> tuple[float, str]:
    """(largest gap of norms over `names`, the leaf that has it)."""
    names = list(names)
    if not names:
        return 0.0, ""
    med = _median(reference[n] for n in names)
    gaps = {n: abs(program[n] - reference[n]) / max(reference[n], med, 1e-30) for n in names}
    worst = max(gaps, key=gaps.get)
    return float(gaps[worst]), worst


def live_leaves(first_grad: dict) -> set:
    """Leaves whose reference first gradient is at least DEAD_LEAF of the
    median leaf's of their model (G., D.); EMA. leaves follow G.'s."""
    live = set()
    for model in ("G.", "D."):
        names = [n for n in first_grad if n.startswith(model)]
        if not names:
            continue
        med = _median(first_grad[n] for n in names)
        live |= {n for n in names if first_grad[n] >= DEAD_LEAF * med}
    live |= {"EMA." + n[2:] for n in live if n.startswith("G.")}
    return live


def median_leaf_gap(program: dict, reference: dict, names) -> tuple[float, str]:
    """The median over `names` of each leaf's gap, taken as in leaf_gap."""
    names = list(names)
    med = _median(reference[n] for n in names)
    return _median(abs(program[n] - reference[n]) / max(reference[n], med, 1e-30)
                   for n in names), f"median of {len(names)} leaves"


def train_checks(program: dict, reference: dict) -> dict:
    """program / reference: {"losses": [[loss_d, loss_g], ...], "grad":
    {leaf: norm}, "change": {leaf: norm}} -> {number: (value, where)}."""
    gaps = [(abs(p - r) / max(abs(r), 1e-30), f"step {i} {k}")
            for i, (ps, rs) in enumerate(zip(program["losses"], reference["losses"]))
            for k, p, r in zip(("loss_d", "loss_g"), ps, rs)]
    live = live_leaves(reference["grad"])
    out = {"loss_gap": max(gaps), "first_loss_gap": max(gaps[:2]),
           "grad_gap": leaf_gap(program["grad"], reference["grad"], reference["grad"]),
           "grad_median_gap": median_leaf_gap(program["grad"], reference["grad"],
                                              reference["grad"])}
    out["change_gap"], medians = (0.0, ""), []
    for model in ("G.", "D.", "EMA."):
        names = [n for n in reference["change"] if n.startswith(model) and n in live]
        if names:
            out["change_gap"] = max(out["change_gap"],
                                    leaf_gap(program["change"], reference["change"], names))
            med = _median(reference["change"][n] for n in names)
            medians += [abs(program["change"][n] - reference["change"][n])
                        / max(reference["change"][n], med, 1e-30) for n in names]
    out["change_median_gap"] = (_median(medians), f"median of {len(medians)} leaves")
    return out


def serve_checks(program: list, reference: list) -> dict:
    """Lists of uint8 videos, request by request -> {number: (value, where)}."""
    diffs = [np.abs(p.astype(np.int16) - r.astype(np.int16)) for p, r in zip(program, reference)]
    per_video = [(float(d[i].mean()), f"request {k} video {i}")
                 for k, d in enumerate(diffs) for i in range(len(d))]
    total = sum(float(d.sum()) for d in diffs) / max(sum(d.size for d in diffs), 1)
    return {"video_gap": (total, "all compared pixels"), "worst_video_gap": max(per_video)}


def judge(checks: dict, limits: dict):
    """(correct, [(name, value, limit, where)]) over the numbers the
    configuration compares. A limit of null leaves that number out (it has
    no upper reading); a number the configuration names no limit for fails."""
    rows = [(name, value, limits.get(name), where) for name, (value, where) in checks.items()
            if not (name in limits and limits[name] is None)]
    ok = all(lim is not None and np.isfinite(v) and v <= lim for _, v, lim, _ in rows)
    return bool(ok), rows
