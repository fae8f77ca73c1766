"""The comparison that decides ``correct``: served rows against the plain
reference (:mod:`hi2bench.reference.hi2`) on the same planes and
queries.  Three numbers, each with its limit in the configuration's
``limits``:

  ncand_off  queries whose served ``n_candidates`` equals that of no
             correct float32 dispatch (the reference's, or its second
             choice at a near tie); exact, limit 0.
  rank_gap   the widest gap, over the sampled queries and ranks r, by
             which the served document at rank r scores below the
             reference's document at rank r (both scored by the
             reference in float64).  A served id that is no candidate of
             the query, a repeated id, or a pad where the reference has
             a document reads :data:`NOT_A_CANDIDATE`.
  score_err  the widest gap between a served score and the reference's
             float64 score of the same document.

The reference is the module that the configuration names
(``"reference"``, default ``hi2``) under ``reference/``.
"""
from __future__ import annotations

import importlib

import numpy as np
import torch

from hi2bench.reference import ops

#: what a served row reads that no correct search can give
NOT_A_CANDIDATE = 1e30
NAMES = ("ncand_off", "rank_gap", "score_err")


def reference(cfg: dict):
    """The configuration's reference module; it has to model every
    ``ServeConfig`` setting that the configuration sets."""
    mod = importlib.import_module(
        "hi2bench.reference." + cfg.get("reference", "hi2"))
    extra = set(cfg.get("serve", {})) - set(mod.SERVE)
    if extra:
        raise ValueError(f"reference {mod.__name__} models no serve "
                         f"setting {sorted(extra)}")
    return mod


def _row_numbers(ref, p, qe, ranked, ids, scores):
    """Per query (gap, err) of served (ids, scores) against one dispatch
    choice."""
    mine = ref.final_scores(p, qe, ranked, ids)
    theirs = ranked.top_scores.double()
    pad = ids < 0
    bad = (~pad & ~torch.isfinite(mine)) | (pad & torch.isfinite(theirs))
    srt = torch.sort(torch.where(pad, ops.SENTINEL, ids), dim=-1)[0]
    dup = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] != ops.SENTINEL)
    gap = torch.where(pad | ~torch.isfinite(theirs), 0.0, theirs - mine)
    gap = gap.clamp(min=0).amax(1)
    gap = torch.where(bad.any(1) | dup.any(1), NOT_A_CANDIDATE, gap)
    err = torch.where(pad | ~torch.isfinite(mine), 0.0,
                      (scores.double() - mine).abs()).amax(1)
    return gap, err


def compare(p, cfg: dict, qe: torch.Tensor, qt: torch.Tensor,
            ids: torch.Tensor, scores: torch.Tensor, ncand: torch.Tensor,
            block: int = 256) -> dict:
    """The three numbers over served rows (ids (n, R), scores (n, R),
    ncand (n,)) of queries (qe, qt), every tensor on the planes'
    device."""
    ref = reference(cfg)
    off, gap, err = 0, 0.0, 0.0
    for i in range(0, qe.shape[0], block):
        sl = slice(i, i + block)
        first, tie, second = ref.search(p, qe[sl], qt[sl], cfg,
                                        tau=cfg["dispatch_tie"])
        nc = ncand[sl].long()
        g1, e1 = _row_numbers(ref, p, qe[sl], first, ids[sl].long(),
                              scores[sl])
        ok1 = first.n_cand == nc
        g, e, ok = g1, e1, ok1
        if second is not None:
            t = tie.nonzero()[:, 0]
            g2, e2 = _row_numbers(ref, p, qe[sl][t], second,
                                  ids[sl][t].long(), scores[sl][t])
            ok2 = second.n_cand == nc[t]
            # a served row matches a choice by its count; where it
            # matches both or neither, the nearer choice is taken
            take2 = (ok2 & ~ok1[t]) | ((ok2 == ok1[t]) & (g2 < g1[t]))
            g, e, ok = g.clone(), e.clone(), ok.clone()
            g[t] = torch.where(take2, g2, g1[t])
            e[t] = torch.where(take2, e2, e1[t])
            ok[t] = ok1[t] | ok2
        off += int((~ok).sum())
        gap = max(gap, float(g.max()))
        err = max(err, float(e.max()))
    return {"ncand_off": off, "rank_gap": gap, "score_err": err}


def control_rows(p, cfg: dict, qe: torch.Tensor, qt: torch.Tensor,
                 dtype=ops.TF32, block: int = 256):
    """The control: the reference put in the program's place at the
    precision below the configuration's (TF32 products), as served rows
    (ids, scores, ncand)."""
    ref = reference(cfg)
    out = []
    for i in range(0, qe.shape[0], block):
        r, _, _ = ref.search(p, qe[i:i + block], qt[i:i + block], cfg,
                             dtype=dtype)
        out.append((r.top_ids, torch.where(torch.isfinite(r.top_scores),
                                           r.top_scores.double(), 0.0),
                    r.n_cand))
    return tuple(torch.cat(x) for x in zip(*out))


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number within its limit."""
    return all(numbers[k] <= limits[k] for k in NAMES)


def lines(numbers: dict, limits: dict) -> list:
    """One line a number, beside its limit."""
    return [f"check {k} {numbers[k]!r} limit {limits[k]!r}" for k in NAMES]


def as_numpy_rows(results: list, rows: list):
    """Served rows of some requests as (ids, scores, ncand, pool rows)
    numpy planes, one row a query."""
    ids, sc, nc, pr = [], [], [], []
    for res, r in zip(results, rows):
        ids.append(np.atleast_2d(res.doc_ids))
        sc.append(np.atleast_2d(res.scores))
        nc.append(np.atleast_1d(res.n_candidates))
        pr.append(r)
    return (np.concatenate(ids), np.concatenate(sc), np.concatenate(nc),
            np.concatenate(pr))
