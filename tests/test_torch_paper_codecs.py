"""The port's Table 2 (``table2_robustness``) and Table 3
(``table3_codec``) against the live reference scripts on the CPU, and
Table 3's ``--smoke --check --device cpu`` run.

Both ``benchmarks/common`` modules are shrunk alike (N 3,000, 64
queries, h 32, V 2,048, 32 clusters).  The reference's scripts run
whole; a spy around ``hi.build`` records the indexes they build (two
encoders; five codecs over one KMeans), which reach the port through
``save_index``/``load_index`` and feed the port's rows functions.  Every
search is paired with the reference's under the rule of
``tests/_torch_paper.py`` (DESIGN.md §11): ``candidates``,
``candidate_budget``, ``candidate_cost``, ``bytes_per_doc`` and
``index_bytes`` exact; R@10, R@100 and MRR@10 equal up to 1/n_queries
for each query with a near-tie swap (the ``flat`` codec's too: the two
frameworks sum its dots in other orders, one ulp apart); the refine
contract's status the same.  The smoke run writes only its ``--out``
and has the reference's report keys.
"""
import json
import os
import subprocess
import sys

import pytest
import torch

import _torch_paper as tp
from benchmarks import common as jcommon
from benchmarks import table2_robustness as jtable2
from benchmarks import table3_codec as jtable3
from repro.checkpoint import checkpoint as jckpt
from repro.core import hybrid_index as jhi
from repro.core.codecs import flat as jflat
from repro_torch.benchmarks import common, table2_robustness, table3_codec
from repro_torch.checkpoint import checkpoint as ckpt
from repro_torch.core import codecs
from repro_torch.core import hybrid_index as hi
from repro_torch.core.codecs import flat

torch.set_num_threads(2)

SIZES = dict(N_DOCS=3000, N_QUERIES=64, HIDDEN=32, VOCAB=2048,
             N_CLUSTERS=32)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's Table 2 and Table 3 rows at the shrunk sizes,
    their search logs, and their indexes loaded into the port; the sizes
    stay patched in both packages for the module."""
    out_dir = tmp_path_factory.mktemp("paper_codecs")
    with tp.shrunk(jcommon, common, SIZES, sup_steps=1):
        with tp.recording((jhi, "build")) as builds, \
                tp.recording((jhi, "search"), (jflat, "search")) as t2_log:
            t2 = jtable2.run()
        t2_idx = dict(zip(table2_robustness.ENCODERS,
                          (idx for _, idx in builds)))
        with tp.recording((jhi, "build")) as builds, \
                tp.recording((jhi, "search")) as t3_log:
            t3 = jtable3.run()
        t3_idx = dict(zip(codecs.registered(), (idx for _, idx in builds)))

        def port(jidx):
            return {k: tp.save_and_load(jckpt, ckpt, v, str(out_dir / k))
                    for k, v in jidx.items()}

        yield dict(t2=t2, t2_log=t2_log, t2_idx=port(t2_idx), t3=t3,
                   t3_log=t3_log, t3_idx=port(t3_idx))


def test_table2_rows_match_the_reference(ref):
    with tp.recording((hi, "search"), (flat, "search")) as log:
        got = table2_robustness.rows(ref["t2_idx"], device="cpu")
    ties = tp.pair_logs(ref["t2_log"], log)
    assert len(got) == len(ref["t2"]) == len(ties) == 6
    for want, row, n in zip(ref["t2"], got, ties):
        tp.assert_row(want, row, n, SIZES["N_QUERIES"])
    assert ties[0] == ties[3] == 0              # Flat: ids exact


def test_table3_rows_match_the_reference(ref):
    assert codecs.registered() == [r["codec"] for r in ref["t3"]]
    with tp.recording((hi, "search")) as log:
        got = table3_codec.rows(common.corpus(), ref["t3_idx"],
                                kc=common.KC, k2=common.K2,
                                top_r=common.TOP_R, device="cpu")
    ties = tp.pair_logs(ref["t3_log"], log)
    for want, row, n in zip(ref["t3"], got, ties):
        tp.assert_row(want, row, n, SIZES["N_QUERIES"])
    assert table3_codec.check(got)[0] == jtable3.check(ref["t3"])[0]
    assert table3_codec.RECALL_SLACK == jtable3.RECALL_SLACK
    assert table3_codec.COST_RATIO == jtable3.COST_RATIO


def test_table3_smoke_check_passes_on_cpu(ref, tmp_path):
    out = tmp_path / "report.json"
    env = dict(os.environ, PYTHONPATH=os.path.join(tp.REPO, "src"),
               OMP_NUM_THREADS="2")
    r = subprocess.run(
        [sys.executable, "-m", "repro_torch.benchmarks.table3_codec",
         "--smoke", "--check", "--device", "cpu", "--out", str(out)],
        env=env, capture_output=True, text=True, timeout=600, cwd=tmp_path)
    assert r.returncode == 0, f"stdout:\n{r.stdout}\nstderr:\n{r.stderr}"
    assert sorted(os.listdir(tmp_path)) == ["report.json"]
    report = json.loads(r.stdout)
    assert json.loads(out.read_text()) == report
    literals, _ = tp.reference_dicts(jtable3.__file__, "main")
    top = next(k for k in literals if "refine_contract" in k)
    contract = next(k for k in literals if "recall_slack" in k)
    assert set(report) == top
    assert set(report["refine_contract"]) == contract
    assert report["refine_contract"]["status"] == "checked"
    assert report["refine_contract"]["failures"] == []
    assert report["smoke"] is True and report["bench"] == "codec"
    assert [r["codec"] for r in report["rows"]] == codecs.registered()
    for row in report["rows"]:
        assert set(row) == set(ref["t3"][0])
