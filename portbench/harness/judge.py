"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``portbench/reference``), each number beside the
limit the cell's ``portbench/limits/<workload>.json`` sets.

Serving. A sample of the finished requests, drawn from the seed with the
longest among them, is judged B-scan by B-scan:

- ``malformed``: requests (all of the window's) whose labels or rows have
  another shape, dtype or range than the request asks;
- ``label_gap``: the widest gap, over every pixel of the sample, by which
  the reference's logit of the served label lies below the reference's
  best logit at that pixel (0 where they agree; a near-tie may flip);
- ``rows_mismatch``: served rows that differ from the reference's
  min-path on the boundary maps of the served labels (exact).

Training. The first three steps of the window's own loop against the
reference's three steps from the same weights, batches and draws:

- ``loss_gap``: the largest ``|loss - ref| / |ref|`` over the steps;
- ``grad_norm_gap``: the first gradient as Adam got it (``mu / (1 - b1)``
  after step 1), by the worst leaf: ``|norm - ref norm| / max(ref norm,
  median leaf's ref norm)``;
- ``change_norm_gap``: the parameters' change after step 3 by the same
  measure, over the leaves whose reference gradient is at least 1e-3 of
  the median leaf's (a conv bias under batch-statistics BatchNorm has a
  gradient of rounding alone, and Adam moves it by rounding).
"""

from __future__ import annotations

import numpy as np
import torch

from ..reference import precision
from . import data

def checks(values: dict, limits_: dict) -> tuple:
    """``(correct, {name: {"value", "limit"}})`` in the limits' order."""
    out = {name: {"value": float(values[name]), "limit": float(lim)} for name, lim in limits_.items()}
    return all(c["value"] <= c["limit"] for c in out.values()), out


def gray_to_input(images: np.ndarray, channels: int) -> np.ndarray:
    return images if channels == 1 else np.repeat(images, channels, axis=-1)


def reference_logits(ref, params, cfg, images_u8: np.ndarray, device, precise=True, chunk=8):
    """``(n, C, H, W)`` float32 logits of the reference on ``device``."""
    outs = []
    with torch.no_grad(), precision(precise):
        for i in range(0, len(images_u8), chunk):
            x = ref.preprocess(torch.from_numpy(images_u8[i : i + chunk]).to(device))
            outs.append(ref.logits(params, x, cfg))
    return torch.cat(outs)


def sample_requests(requests: list, seed: int, want_bscans: int) -> list:
    """Indices of the judged requests: the longest, then others drawn from
    the seed until ``want_bscans`` B-scans are in."""
    if not requests:
        return []
    sizes = np.array([len(r["idx"]) for r in requests])
    longest = int(np.argmax(sizes))
    order = [longest] + [int(i) for i in data.rng(seed, data.SAMPLE).permutation(len(requests)) if i != longest]
    picked, total = [], 0
    for i in order:
        if total >= want_bscans:
            break
        picked.append(i)
        total += sizes[i]
    return picked


def well_formed(r: dict, h: int, w: int, classes: int) -> bool:
    n = len(r["idx"])
    lab, rows = r["labels"], r["rows"]
    return (isinstance(lab, np.ndarray) and isinstance(rows, np.ndarray)
            and lab.shape == (n, h, w) and lab.dtype == np.uint8
            and rows.shape == (n, classes - 1, w) and rows.dtype == np.uint16
            and int(lab.max(initial=0)) < classes and int(rows.max(initial=0)) < h)


def serve_readings(ref, params, cfg, pool_images, requests, seed, want_bscans, device,
                   control=False) -> dict:
    """The serving numbers of ``requests`` (dicts of ``idx``, ``labels``,
    ``rows``). With ``control`` the reference in TF32 takes the program's
    place: only its labels are judged (its rows would be the reference's
    own)."""
    from ..reference import minpath

    h, w, classes = cfg["image_height"], cfg["image_width"], cfg["num_classes"]
    bad = 0 if control else sum(not well_formed(r, h, w, classes) for r in requests)
    picked = [requests[i] for i in sample_requests(requests, seed, want_bscans)]
    if not control:
        picked = [r for r in picked if well_formed(r, h, w, classes)]
    if not picked:
        return {"malformed": bad, "label_gap": float("inf"), "rows_mismatch": 0, "judged_bscans": 0}
    idx = np.unique(np.concatenate([r["idx"] for r in picked]))
    where = {int(k): i for i, k in enumerate(idx)}
    inputs = gray_to_input(pool_images[idx], cfg["input_channels"])
    logits = reference_logits(ref, params, cfg, inputs, device)
    if control:
        ctrl = reference_logits(ref, params, cfg, inputs, device, precise=False).argmax(1).to(torch.uint8)
    gap, judged = 0.0, 0
    for r in picked:
        for j, k in enumerate(r["idx"]):
            lg = logits[where[int(k)]]
            lab = ctrl[where[int(k)]] if control else torch.from_numpy(r["labels"][j]).to(device)
            served = lg.gather(0, lab.long()[None])[0]
            gap = max(gap, float((lg.max(0).values - served).max()))
            judged += 1
    if control:
        return {"label_gap": gap, "judged_bscans": judged}
    labels = np.concatenate([r["labels"] for r in picked] or [np.zeros((0, h, w), np.uint8)])
    rows = np.concatenate([r["rows"] for r in picked] or [np.zeros((0, classes - 1, w), np.uint16)]).astype(np.int64)
    mismatch = 0
    for j in range(0, len(labels), 128):
        want = minpath.rows_from_labels(torch.from_numpy(labels[j : j + 128]).to(device), classes)
        mismatch += int((want.cpu().numpy() != rows[j : j + 128]).sum())
    return {
        "malformed": bad,
        "label_gap": gap,
        "rows_mismatch": mismatch,
        "judged_bscans": judged,
    }


def _norm(t) -> float:
    return float(torch.linalg.vector_norm(t.double()))


def train_readings(losses, first_grads, changes, ref_losses, ref_grads, ref_changes) -> dict:
    """The training numbers from per-leaf dicts of tensors."""
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    gn = {n: _norm(g) for n, g in ref_grads.items()}
    med = float(np.median(list(gn.values())))
    grad_gap = max(abs(_norm(first_grads[n]) - gn[n]) / max(gn[n], med) for n in gn)
    moved = [n for n in gn if gn[n] >= 1e-3 * med]
    cn = {n: _norm(ref_changes[n]) for n in moved}
    med_c = float(np.median(list(cn.values())))
    change_gap = max(abs(_norm(changes[n]) - cn[n]) / max(cn[n], med_c) for n in moved)
    return {
        "loss_gap": loss_gap,
        "loss_gap_step1": abs(losses[0] - ref_losses[0]) / abs(ref_losses[0]),
        "grad_norm_gap": grad_gap,
        "change_norm_gap": change_gap,
        "leaves_left_out": len(gn) - len(moved),
    }
