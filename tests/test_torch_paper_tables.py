"""The port's paper benchmarks over ``benchmarks/common.py`` — ``common``,
Table 1 (``table1_main``), Figure 3 (``fig3_tradeoff``) and Figure 4
(``fig4_ablation``) — against the live reference scripts on the CPU.

Both ``common`` modules are shrunk alike (N 3,000, 64 queries, h 32,
V 2,048, 32 clusters, 20 HI²_sup steps).  The reference's scripts run
whole; a spy around ``hi.build`` records the indexes they build, which
reach the port through ``save_index``/``load_index`` and feed the
port's rows functions.  Spies around both packages' ``hi.search`` and
``flat.search`` pair every search, under the rule of
``tests/_torch_paper.py`` (DESIGN.md §11): candidates, costs and bytes
exact; recall and MRR equal up to 1/n_queries for each query with a
near-tie swap.  Table 1's Distill-VQ and HI²_sup indexes are also built
by the port from the reference's trained parameters (carried across by
``distill_params_from_numpy``): their lists and φ(D) equal the
reference's, and so do their rows' candidates and bytes.

The reference runs once per module.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import _torch_paper as tp
from benchmarks import common as jcommon
from benchmarks import fig3_tradeoff as jfig3
from benchmarks import fig4_ablation as jfig4
from benchmarks import table1_main as jtable1
from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core.codecs import flat as jflat
from repro_torch.benchmarks import (common, fig3_tradeoff, fig4_ablation,
                                    table1_main, table2_robustness,
                                    table3_codec, hybrid_fusion,
                                    filtered_search)
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import hybrid_index as hi
from repro_torch.core.codecs import flat
from repro_torch.examples import quickstart, serve_retrieval, \
    train_hi2_distill

torch.set_num_threads(2)

SIZES = dict(N_DOCS=3000, N_QUERIES=64, HIDDEN=32, VOCAB=2048,
             N_CLUSTERS=32)
SUP_STEPS = 20
SHARED = ("N_DOCS", "N_QUERIES", "HIDDEN", "VOCAB", "N_CLUSTERS",
          "COMMON_INDEX", "KC", "K2", "TOP_R")


def _searches(*modules):
    return tp.recording(*[(m, "search") for m in modules])


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's Table 1, Figure 3 and Figure 4 at the shrunk
    sizes, with their search logs and indexes (JAX and loaded into the
    port); the sizes stay patched in both packages for the module."""
    defaults = {k: (getattr(jcommon, k), getattr(common, k)) for k in SHARED}
    out_dir = tmp_path_factory.mktemp("paper_tables")
    with tp.shrunk(jcommon, common, SIZES, SUP_STEPS):
        with tp.recording((jhi, "build")) as builds:
            jcommon.unsup_index()
            jcommon.sup_index()
            with _searches(jhi, jflat) as t1_log:
                t1 = jtable1.run()
            with _searches(jhi) as f3_log:
                f3 = jfig3.run()
            with _searches(jhi) as f4_log:
                f4 = jfig4.run()
        jidx = dict(zip(("unsup", "sup", "distill_vq"),
                        (idx for _, idx in builds)))
        assert len(builds) == 3
        tidx = {k: tp.save_and_load(jckpt, ckpt, v, str(out_dir / k))
                for k, v in jidx.items()}
        yield dict(defaults=defaults, t1=t1, t1_log=t1_log, f3=f3,
                   f3_log=f3_log, f4=f4, f4_log=f4_log, jidx=jidx,
                   tidx=tidx)


def test_common_matches_the_reference(ref):
    for name, (want, got) in ref["defaults"].items():
        assert got == want, name
    assert common.SUP_STEPS == SUP_STEPS
    c, jc = common.corpus(), jcommon.corpus()
    for field in ("doc_emb", "doc_tokens", "query_emb", "query_tokens",
                  "qrels", "doc_emb_b", "query_emb_b"):
        np.testing.assert_array_equal(getattr(c, field), getattr(jc, field))
    qe, qt = common.queries()
    np.testing.assert_array_equal(qe, np.asarray(jcommon.queries()[0]))
    np.testing.assert_array_equal(qt, np.asarray(jcommon.queries()[1]))
    for name, jidx in ref["jidx"].items():
        assert (common.index_size_bytes(ref["tidx"][name])
                == jcommon.index_size_bytes(jidx)), name
    # evaluate on one search of each package
    jres = jhi.search(ref["jidx"]["unsup"], *jcommon.queries(), kc=2, k2=3,
                      top_r=100)
    res = hi.search(ref["tidx"]["unsup"], qe, qt, kc=2, k2=3, top_r=100,
                    device="cpu")
    tp.assert_row(jcommon.evaluate(jres), common.evaluate(res),
                  tp.search_pair(jres, res), len(qe))
    assert common.time_call(lambda: None, device="cpu") > 0


def test_table1_rows_match_the_reference(ref):
    with _searches(hi, flat) as log:
        got = table1_main.rows(ref["tidx"], device="cpu")
    ties = tp.pair_logs(ref["t1_log"], log)
    assert [r["method"] for r in got] == [r["method"] for r in ref["t1"]]
    for want, row, n in zip(ref["t1"], got, ties):
        tp.assert_row(want, row, n, SIZES["N_QUERIES"])
    assert ties[0] == 0                         # Flat: ids exact


def test_table1_builds_from_the_reference_sup_parameters(ref, monkeypatch):
    """The port's Distill-VQ and HI²_sup builds, from the parameters the
    reference trained: the reference's φ(D) and cluster lists, and the
    same candidates and bytes in their rows."""
    params, jcfg, assign = jcommon.sup_artifacts()
    enc_cfg = ckpt.enc_cfg_from_fields(dataclasses.asdict(jcfg))
    leaves = {jax.tree_util.keystr(p): np.asarray(a) for p, a in
              jax.tree_util.tree_flatten_with_path(params)[0]}
    carried = (ckpt.distill_params_from_numpy(leaves, enc_cfg, device="cpu"),
               enc_cfg, torch.from_numpy(np.array(assign)))
    monkeypatch.setattr(common, "sup_artifacts", lambda device: carried)
    tp.clear_caches(common)
    built = table1_main.build("cpu")
    for name in ("distill_vq", "sup"):
        want, got = ref["jidx"][name], built[name]
        np.testing.assert_array_equal(got.doc_assign.numpy(),
                                      np.asarray(want.doc_assign))
        for part in ("entries", "lengths"):
            np.testing.assert_array_equal(
                getattr(got.cluster_lists, part).numpy(),
                np.asarray(getattr(want.cluster_lists, part)))
    rows = {r["method"]: r for r in table1_main.rows(built, device="cpu")}
    want = {r["method"]: r for r in ref["t1"]}
    for method in ("Distill-VQ", "HI2_sup"):
        for key in ("candidates", "index_bytes"):
            assert rows[method][key] == want[method][key], (method, key)
    tp.clear_caches(common)


def test_fig3_points_match_the_reference(ref):
    with _searches(hi) as log:
        got = fig3_tradeoff.rows(ref["tidx"]["unsup"], ref["tidx"]["sup"],
                                 device="cpu")
    tp.assert_points(ref["f3"], got, tp.pair_logs(ref["f3_log"], log),
                     SIZES["N_QUERIES"])


def test_fig4_points_match_the_reference(ref):
    with _searches(hi) as log:
        got = fig4_ablation.rows(ref["tidx"]["unsup"], device="cpu")
    tp.assert_points(ref["f4"], got, tp.pair_logs(ref["f4_log"], log),
                     SIZES["N_QUERIES"])


@pytest.mark.parametrize("module", [
    table1_main, table2_robustness, table3_codec, fig3_tradeoff,
    fig4_ablation, hybrid_fusion, filtered_search, quickstart,
    serve_retrieval, train_hi2_distill],
    ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_entry_point_raises_without_a_card(module):
    """Every script and example defaults to the card and refuses to go
    on without one (``--device cpu`` is the plain path)."""
    if torch.cuda.is_available():
        pytest.skip("a card is visible")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main([])
