"""The port's self-contained paper scripts on the CPU: ``hybrid_fusion``
and ``filtered_search`` against the live reference scripts, their
``--smoke --check --device cpu`` runs, ``filters.allow_all`` and
``namespace_histogram`` against the reference's, and the three examples
(``quickstart``, ``serve_retrieval``, ``train_hi2_distill``) shrunk
in-process.

Each reference script runs whole at its ``--smoke`` size; spies record
the corpus and the index it builds (which reaches the port through
``save_index``/``load_index``) and every search, and the port's
``run_rows`` sweeps that index.  Searches pair under the rule of
``tests/_torch_paper.py`` (DESIGN.md §11): candidates and costs exact,
recall equal up to 1/n_queries for each query with a near-tie swap (in
the search or, for the filtered oracle, in its brute force); every other
report field equal but the wall-clock ``search_us_per_batch``.
"""
import argparse
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import _torch_paper as tp
from benchmarks import filtered_search as jfiltered
from benchmarks import hybrid_fusion as jhybrid
from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core.codecs import flat as jflat
from repro.core.exec import filters as jfilters
from repro.data import synthetic as jsynthetic
from repro_torch.benchmarks import filtered_search, hybrid_fusion
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import codecs
from repro_torch.core import hybrid_index as hi
from repro_torch.core.codecs import flat
from repro_torch.core.exec import filters
from repro_torch.data import synthetic
from repro_torch.examples import quickstart, serve_retrieval, \
    train_hi2_distill

torch.set_num_threads(2)

TIMED = 7                    # searches of one _time_call (2 warm + 5)
SCRIPTS = {"hybrid_fusion": (jhybrid, hybrid_fusion),
           "filtered_search": (jfiltered, filtered_search)}


def _args(**kw):
    return argparse.Namespace(smoke=True, check=True, codec=None, top_r=100,
                              out=None, **kw)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """name → (reference report, its log of searches, its corpus, the
    index it built loaded into the port)."""
    out = {}
    for name, (jmod, _) in SCRIPTS.items():
        with tp.recording((jsynthetic, "generate"),
                          (jhi, "build")) as built, \
                tp.recording((jhi, "search"), (jflat, "search")) as log:
            report = jmod.run(_args())
        (_, corpus), (_, jidx) = built
        idx = tp.save_and_load(jckpt, ckpt, jidx,
                               str(tmp_path_factory.mktemp(name)))
        out[name] = (report, log, corpus, idx)
    return out


def _strip_times(report: dict) -> dict:
    if isinstance(report, dict):
        return {k: _strip_times(v) for k, v in report.items()
                if k != "search_us_per_batch"}
    if isinstance(report, list):
        return [_strip_times(v) for v in report]
    return report


def _assert_report(want: dict, got: dict, metric_ties: dict, n_q: int):
    """Equal apart from times; the metrics at each path in
    ``metric_ties`` within its ties / n_q."""
    want, got = _strip_times(want), _strip_times(got)
    for path, n in metric_ties.items():
        w, g = want, got
        for key in path[:-1]:
            w, g = w[key], g[key]
        assert abs(g[path[-1]] - w[path[-1]]) <= n / n_q + tp.FLOAT, path
        g[path[-1]] = w[path[-1]]
    assert got == want


def test_hybrid_fusion_report_matches_the_reference(ref):
    want, want_log, corpus, idx = ref["hybrid_fusion"]
    with tp.recording((hi, "search"), (flat, "search")) as log:
        got = hybrid_fusion.run_rows(_args(device="cpu"), corpus, idx)
    ties = tp.pair_logs(want_log, log)
    # the log: dense, its timing, the fallback, then each weight's search
    # and its timing
    n = {("dense_only", "R@100"): ties[0]}
    for i, _ in enumerate(hybrid_fusion.WEIGHTS):
        n[("points", i, "R@100")] = ties[TIMED + 2 + i * (TIMED + 1)]
    best = hybrid_fusion.WEIGHTS.index(want["best_weight"])
    n[("best_R@100",)] = n[("points", best, "R@100")]
    _assert_report(want, got, n, corpus.query_emb.shape[0])
    assert got["check_failures"] == []


def test_filtered_search_report_matches_the_reference(ref):
    want, want_log, corpus, idx = ref["filtered_search"]
    doc_ns = np.random.RandomState(0).randint(
        0, want["n_namespaces"], size=want["n_docs"]).astype(np.int32)
    np.testing.assert_array_equal(idx.doc_ns.numpy(), doc_ns)
    with tp.recording((hi, "search"), (flat, "search")) as log:
        got = filtered_search.run_rows(_args(device="cpu"), corpus, doc_ns,
                                       idx)
    ties = tp.pair_logs(want_log, log)
    # the log: unfiltered, allow-all, then each point's search, its
    # timing and its oracle's brute-force passes
    names = [name for name, _ in log]
    starts = [2] + [i for i in range(3, len(names))
                    if names[i] == "hybrid_index.search"
                    and names[i - 1] == "flat.search"]
    assert len(starts) == len(want["points"])
    n = {}
    for p, s in enumerate(starts):
        end = starts[p + 1] if p + 1 < len(starts) else len(names)
        n[("points", p, "R@R_vs_filtered_oracle")] = ties[s] + sum(
            ties[i] for i in range(s, end) if names[i] == "flat.search")
    _assert_report(want, got, n, corpus.query_emb.shape[0])
    assert got["check_failures"] == []


def _reference_keys(jmod, point_key: str) -> tuple:
    """(report keys, point keys) from the reference's dict literals."""
    literals, assigned = tp.reference_dicts(jmod.__file__, "run", top_r=100)
    report = next(k for k in literals if "bench" in k) | assigned["report"]
    point = next(k for k in literals if point_key in k)
    return report, point | assigned.get("point", set())


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_smoke_check_passes_on_cpu(name, tmp_path):
    jmod, mod = SCRIPTS[name]
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(tp.REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", mod.__name__, "--smoke", "--check",
         "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert sorted(os.listdir(tmp_path)) == ["report.json"]
    report = json.loads(r.stdout)
    assert json.loads(out.read_text()) == report
    assert report["check_failures"] == [] and report["smoke"] is True
    keys, point = _reference_keys(
        jmod, "fusion_weight" if name == "hybrid_fusion"
        else "allowed_namespaces")
    assert set(report) == keys
    for p in report["points"]:
        assert set(p) <= point and set(point) - set(p) <= {
            "ids_equal_dense_only"}
    if name == "hybrid_fusion":
        literals, _ = tp.reference_dicts(jmod.__file__, "run", top_r=100)
        assert set(report["dense_only"]) == next(
            k for k in literals
            if "mean_candidates" in k and "fusion_weight" not in k)
        assert "ids_equal_dense_only" in report["points"][-1]
        assert report["fallback_equals_dense"]
    else:
        assert report["allow_all_equals_unfiltered"]
        assert all(p["tenant_isolated"] for p in report["points"])


@pytest.mark.parametrize("batch,n_ns", [(1, 1), (5, 31), (7, 32), (3, 70)])
def test_allow_all_and_histogram_equal_the_reference(batch, n_ns):
    want = np.asarray(jfilters.allow_all(batch, n_ns))
    got = filters.allow_all(batch, n_ns, device="cpu")
    assert got.dtype == torch.int64 and int(got.max()) < 2 ** 32
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert torch.equal(filters.as_words(want, "cpu"), got)
    doc_ns = np.random.default_rng(n_ns).integers(0, n_ns, 500)
    hist = filters.namespace_histogram(doc_ns, n_ns + 3)
    ref_hist = jfilters.namespace_histogram(doc_ns, n_ns + 3)
    np.testing.assert_array_equal(hist, ref_hist)
    assert hist.dtype == ref_hist.dtype
    np.testing.assert_array_equal(
        filters.namespace_histogram(torch.from_numpy(doc_ns), n_ns + 3),
        ref_hist)


def test_search_with_allow_all_is_bit_identical_to_no_filter():
    c = synthetic.generate(seed=1, n_docs=1200, n_queries=16, hidden=32,
                           vocab_size=512, n_topics=8)
    n_ns = 37
    idx = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, n_clusters=12,
                   k1_terms=4, pq_m=4, pq_k=64, kmeans_iters=3,
                   doc_namespaces=np.arange(1200) % n_ns, device="cpu")
    kw = dict(kc=4, k2=6, top_r=50, device="cpu")
    ref = hi.search(idx, c.query_emb, c.query_tokens, **kw)
    got = hi.search(idx, c.query_emb, c.query_tokens,
                    filter=filters.allow_all(16, n_ns, device="cpu"), **kw)
    for field in ("doc_ids", "scores", "n_candidates"):
        assert torch.equal(getattr(got, field), getattr(ref, field))


EXAMPLES = {
    quickstart: dict(N_DOCS=1500, N_QUERIES=48, N_CLUSTERS=16),
    serve_retrieval: dict(N_DOCS=1500, N_QUERIES=128, N_CLUSTERS=16),
    train_hi2_distill: dict(N_DOCS=1500, N_QUERIES=64, N_CLUSTERS=16,
                            N_STEPS=4),
}


@pytest.mark.parametrize("module", list(EXAMPLES),
                         ids=lambda m: m.__name__.rsplit(".", 1)[-1])
def test_example_runs_on_cpu_and_prints_its_table(module, monkeypatch,
                                                   capsys):
    for name, value in EXAMPLES[module].items():
        monkeypatch.setattr(module, name, value)
    module.main(["--device", "cpu"])
    text = capsys.readouterr().out
    if module is quickstart:
        assert (f"{'method':<22}{'R@100':>8}{'MRR@10':>9}{'candidates':>12}"
                in text)
        for name in ("Flat (brute force)", "IVF-OPQ", "HI2_unsup"):
            assert name in text
        table = text.split("codec sweep")[1].splitlines()[2:]
        assert [line.split()[0] for line in table] == codecs.registered()
    elif module is serve_retrieval:
        assert "index persisted+restored from" in text
        assert "served 128 queries" in text and "R@100=" in text
    else:
        assert "distillation loss" in text
        for name in ("HI2_unsup", "HI2_sup"):
            line = next(x for x in text.splitlines() if x.startswith(name))
            assert "R@100=" in line and "MRR@10=" in line
