"""Whole runs at tiny sizes on the CPU, with the timed path broken
underneath the runtime (``Server._search``, which each bucket's program
runs): every fault that a cell can have makes ``correct`` false, and
the sound path keeps it true.  Each run is a fresh process, as the
benchmark's runs are."""
from __future__ import annotations

import pytest

from hi2bench import spec
from hi2bench.conftest import ROOT, SRC, last_json, run_script

#: the program's search, broken in one way each
FAULTS = {
    "sound": "",
    # a step that returns its state unchanged: every batch gets the
    # first batch's rows
    "unchanged": """
def broken(self, qe, qt, **kw):
    if not hasattr(broken, "first"):
        broken.first = orig(self, qe, qt, **kw)
    return broken.first
""",
    # half of each batch left out: its back half gets no search
    "half_batch": """
def broken(self, qe, qt, **kw):
    res = orig(self, qe, qt, **kw)
    h = (qe.shape[0] + 1) // 2
    ids, sc, nc = (res.doc_ids.clone(), res.scores.clone(),
                   res.n_candidates.clone())
    ids[h:] = -1
    sc[h:] = float("-inf")
    nc[h:] = 0
    return res._replace(doc_ids=ids, scores=sc, n_candidates=nc)
""",
    # an answer altered where it is produced: each row's best id
    "altered": """
def broken(self, qe, qt, **kw):
    res = orig(self, qe, qt, **kw)
    ids = res.doc_ids.clone()
    ids[:, 0] = (ids[:, 0] + 1) % self.index.doc_assign.shape[0]
    return res._replace(doc_ids=ids)
""",
}

DRIVER = """
import sys
from repro_torch.launch import serve
orig = serve.Server._search
{fault}
if "broken" in dir():
    serve.Server._search = broken
sys.argv[0] = "run.py"
from hi2bench import run
sys.exit(run.main(sys.argv[1:]))
"""

#: every cell of BENCHMARK.json (a data file, read alike by every worker)
CELLS = [w["name"] for w in spec.load()["workloads"]]


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault):
    rc, out, err = run_script(
        ["--workload", cell, "--seed", 2**31 + 2**20 + 11, "--seconds",
         "0.5", "--trace", "0", "--device", "cpu", "--tiny"],
        code=DRIVER.format(fault=FAULTS[fault]), pythonpath=(ROOT, SRC))
    assert rc == 0, err[-3000:]
    res = last_json(out)
    assert res["correct"] is (fault == "sound"), res["checks"]
    # the compared numbers come last on standard error, beside limits
    tail = err.strip().splitlines()[-3:]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)
    assert list(res)[-1] == "checks"
