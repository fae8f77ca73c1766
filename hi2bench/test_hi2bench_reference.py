"""The plain reference against an independent brute force and against
the port's CPU path, and the control against the comparison, at tiny
sizes on the CPU.  (The test, not the reference, imports the port.)"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from hi2bench import check, planes as planes_mod
from hi2bench.conftest import micro
from hi2bench.reference import hi2 as ref, ops

#: the benchmark's configurations, and their codec swapped for another
#: that the codec files cover (the stage-1 codec alone; a refine over
#: OPQ's codes)
CONFIGS = (("msmarco_opq", None), ("msmarco_refine_sq8", None),
           ("msmarco_refine_sq8", "sq8"), ("msmarco_opq", "refine:opq:2"))
IDS = [c if k is None else f"{c}-{k}" for c, k in CONFIGS]


def _drawn(config, seed, pool=12, codec=None):
    cfg = micro(config)
    if codec is not None:
        cfg["codec"] = codec
    p, (qe, qt), extra = planes_mod.draw(cfg, seed, torch.device("cpu"),
                                         pool)
    return cfg, p, qe, qt, extra


def _first_desc(keys, ids):
    """Positions in (key desc, id asc) order."""
    return np.lexsort((ids, -keys))


def _brute(p, cfg, x, tokens):
    """One query by loops in float64 numpy: (clusters, terms, candidate
    ids ascending, top ids, top scores)."""
    x = x.astype(np.float64)
    emb = p.cluster_emb.numpy().astype(np.float64)
    cs = emb @ x
    clusters = _first_desc(cs, np.arange(cs.size))[:cfg["kc"]]
    seen = []
    for t in tokens.tolist():
        if t >= 0 and t not in seen:
            seen.append(t)
    avg = p.avg_scores.numpy().astype(np.float64)
    by = sorted(range(len(seen)), key=lambda i: (-avg[seen[i]], i))
    terms = [seen[i] for i in by[:cfg["k2"]]]
    cand = set()
    for c in clusters:
        cand |= {int(d) for d in p.cluster_entries[c].tolist() if d >= 0}
    for t in terms:
        cand |= {int(d) for d in p.term_entries[t].tolist() if d >= 0}
    cand = np.array(sorted(cand), dtype=np.int64)
    codes = p.codes.numpy()[cand].astype(np.int64)
    prm = {k: v.numpy().astype(np.float64) for k, v in p.params.items()}
    if p.base == "opq":
        # the document's vector in the rotated space, code by code
        cw = prm["codewords"]
        vec = np.concatenate([cw[j, codes[:, j]]
                              for j in range(cw.shape[0])], 1)
        s = vec @ (x @ prm["rotation"])
    else:
        s = (prm["lo"] + prm["scale"] * codes) @ x
    top = _first_desc(s, cand)[:cfg["top_r"] * p.refine_mult]
    ids, sc = cand[top], s[top]
    if p.refine_emb is not None:
        ex = p.refine_emb.numpy().astype(np.float64)[ids] @ x
        top = _first_desc(ex, ids)[:cfg["top_r"]]
        ids, sc = ids[top], ex[top]
    return clusters, terms, cand, ids, sc


@pytest.mark.parametrize("config,codec", CONFIGS, ids=IDS)
def test_reference_matches_brute_force(config, codec):
    cfg, p, qe, qt, _ = _drawn(config, 2**31 + 17, codec=codec)
    first, _, _ = ref.search(p, qe, qt, cfg)
    cl, _, _, tm = ref.dispatch(p, qe, qt, cfg["kc"], cfg["k2"],
                                torch.float64, 0.0)
    for b in range(qe.shape[0]):
        clusters, terms, cand, ids, sc = _brute(p, cfg, qe[b].numpy(),
                                                qt[b].numpy())
        assert cl[b].tolist() == clusters.tolist()
        assert [t for t in tm[b].tolist() if t >= 0] == terms
        assert int(first.n_cand[b]) == cand.size
        live = first.cand[b][first.cand[b] != ref.SENTINEL]
        assert live.tolist() == cand.tolist()
        r = ids.size
        assert first.top_ids[b, :r].tolist() == ids.tolist()
        np.testing.assert_allclose(first.top_scores[b, :r].numpy(), sc,
                                   rtol=1e-12, atol=1e-12)
        assert bool((first.top_ids[b, r:] == ref.PAD).all())


def _port_rows(cfg, p, extra, qe, qt):
    from hi2bench import system
    server = system.server(p, extra, cfg, torch.device("cpu"), qe.shape[0])
    res = server.query(qe.numpy(), qt.numpy())
    return (torch.as_tensor(np.asarray(res.doc_ids)).long(),
            torch.as_tensor(np.asarray(res.scores)),
            torch.as_tensor(np.asarray(res.n_candidates)).long())


@pytest.mark.parametrize("config,codec", CONFIGS, ids=IDS)
def test_port_cpu_path_passes_the_comparison(config, codec):
    cfg, p, qe, qt, extra = _drawn(config, 2**31 + 29, codec=codec)
    ids, sc, nc = _port_rows(cfg, p, extra, qe, qt)
    first, _, _ = ref.search(p, qe, qt, cfg)
    assert nc.tolist() == first.n_cand.tolist()
    assert ids.tolist() == first.top_ids.tolist()
    numbers = check.compare(p, cfg, qe, qt, ids, sc, nc)
    assert numbers["ncand_off"] == 0
    assert check.verdict(numbers, cfg["limits"]), numbers


@pytest.mark.parametrize("config", ("msmarco_opq", "msmarco_refine_sq8"))
def test_control_fails_the_comparison(config):
    """The reference at the precision below the configuration's, put in
    the program's place at the tiny sizes, is not correct."""
    from hi2bench import spec
    cfg = spec.sized(spec.config(config), True)
    p, (qe, qt), _ = planes_mod.draw(cfg, 2**31 + 41, torch.device("cpu"),
                                     256)
    ids, sc, nc = check.control_rows(p, cfg, qe, qt)
    numbers = check.compare(p, cfg, qe, qt, ids, sc, nc)
    assert not check.verdict(numbers, cfg["limits"]), numbers


def test_tf32_operands_round_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2**-10, 1.0 + 2**-11 + 2**-13, 1.0 + 2**-12,
                      -(1.0 + 2**-11 + 2**-13)])
    got = ops.op(x, ops.TF32)
    assert got.tolist() == [1.0 + 2**-10, 1.0 + 2**-10, 1.0,
                            -(1.0 + 2**-10)]


def test_comparison_flags_what_no_search_gives():
    cfg, p, qe, qt, _ = _drawn("msmarco_opq", 2**31 + 53)
    first, _, _ = ref.search(p, qe, qt, cfg)
    ids = first.top_ids.clone()
    sc = first.top_scores.clone()
    ok = check.compare(p, cfg, qe, qt, ids, sc, first.n_cand)
    assert ok == {"ncand_off": 0, "rank_gap": 0.0, "score_err": 0.0}
    dup = ids.clone()
    dup[0, 1] = dup[0, 0]
    assert check.compare(p, cfg, qe, qt, dup, sc, first.n_cand)[
        "rank_gap"] == check.NOT_A_CANDIDATE
    swapped = ids.clone()
    swapped[1, [0, 1]] = swapped[1, [1, 0]]
    numbers = check.compare(p, cfg, qe, qt, swapped, sc, first.n_cand)
    assert numbers["rank_gap"] > 0 and numbers["score_err"] > 0
    off = check.compare(p, cfg, qe, qt, ids, sc, first.n_cand + 1)
    assert off["ncand_off"] == qe.shape[0]
