"""Helpers of the paper-benchmark parity tests
(``tests/test_torch_paper_*.py``): import the reference's benchmark
files, record the calls a script makes, carry JAX-built indexes into
the port, and hold rows against the reference's under DESIGN.md §11.

The rule: every recorded search pair has ``n_candidates`` equal and
top-R ids equal up to swaps between scores within ``TOL``, scores within
rtol=atol=``TOL``; a row's recall and MRR are equal, or, where its search
had ``n`` queries with such a swap, within ``n / n_queries`` (one query
moves a single-positive metric by at most 1/n_queries), plus ``FLOAT``
for the f32 mean of the two frameworks' sums.  Counts, costs and bytes
are equal.
"""
import ast
import contextlib
import os
import sys

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:           # the reference's benchmarks/ namespace
    sys.path.insert(0, REPO)

TOL = 1e-4
FLOAT = 1e-6
METRICS = ("R@10", "R@100", "MRR@10", "R100", "R@R_vs_filtered_oracle")


def host(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@contextlib.contextmanager
def recording(*targets):
    """Within the block, each ``(module, name)`` is patched so every
    call's result is appended, in call order, to the yielded list as
    ``(name, result)``."""
    log, saved = [], []
    for module, name in targets:
        orig = getattr(module, name)

        def wrapped(*a, _orig=orig, _name=name, **k):
            out = _orig(*a, **k)
            log.append((f"{_orig.__module__.split('.')[-1]}.{_name}", out))
            return out

        saved.append((module, name, orig))
        setattr(module, name, wrapped)
    try:
        yield log
    finally:
        for module, name, orig in reversed(saved):
            setattr(module, name, orig)


def clear_caches(module) -> None:
    """Empty every ``functools`` cache of ``module``."""
    for name in dir(module):
        fn = getattr(module, name)
        if hasattr(fn, "cache_clear"):
            fn.cache_clear()


@contextlib.contextmanager
def shrunk(jcommon, common, sizes: dict, sup_steps: int):
    """Both packages' ``benchmarks/common`` at ``sizes`` (and HI²_sup at
    ``sup_steps`` steps) within the block, their caches emptied on entry
    and exit."""
    import pytest
    with pytest.MonkeyPatch.context() as mp:
        for name, value in sizes.items():
            mp.setattr(jcommon, name, value)
            mp.setattr(common, name, value)
        mp.setattr(common, "SUP_STEPS", sup_steps)
        cfg = jcommon.tr.SupTrainConfig
        mp.setattr(jcommon.tr, "SupTrainConfig",
                   lambda **kw: cfg(**dict(kw, n_steps=sup_steps)))
        clear_caches(jcommon)
        clear_caches(common)
        try:
            yield
        finally:
            clear_caches(jcommon)
            clear_caches(common)


def save_and_load(jckpt, ckpt, jidx, directory: str):
    """The port's index read from a reference ``save_index`` checkpoint
    of ``jidx``."""
    return ckpt.load_index(jckpt.save_index(directory, 0, jidx),
                           device="cpu")


def differing_rows(want_ids, want_s, got_ids, got_s) -> int:
    """Queries whose top-R ids differ; fails unless every difference is
    a swap between scores within TOL, and unless scores agree."""
    wi, ws, gi, gs = map(host, (want_ids, want_s, got_ids, got_s))
    np.testing.assert_allclose(gs, ws, rtol=TOL, atol=TOL)
    for b, p in zip(*np.nonzero(gi != wi)):
        where = np.flatnonzero(wi[b] == gi[b, p])
        ref = ws[b, where[0]] if where.size else ws[b, -1]
        assert abs(ref - gs[b, p]) <= TOL + TOL * abs(ref), (b, p)
    return int((gi != wi).any(axis=1).sum())


def search_pair(want, got) -> int:
    """Two ``SearchResult``s (the reference's, the port's):
    ``n_candidates`` equal; the queries whose ids differ (near-ties)."""
    np.testing.assert_array_equal(host(got.n_candidates),
                                  host(want.n_candidates))
    return differing_rows(want.doc_ids, want.scores, got.doc_ids, got.scores)


def flat_pair(want, got) -> int:
    """Two ``flat.search`` outputs ((scores, ids) each)."""
    return differing_rows(want[1], want[0], got[1], got[0])


def pair_logs(want_log, got_log) -> list:
    """The near-tie query count of each recorded call, the two logs
    paired in order (the same functions called the same number of
    times)."""
    assert [n for n, _ in got_log] == [n for n, _ in want_log], \
        ([n for n, _ in want_log], [n for n, _ in got_log])
    return [(flat_pair if isinstance(w, tuple) and not hasattr(w, "doc_ids")
             else search_pair)(w, g)
            for (_, w), (_, g) in zip(want_log, got_log)]


def assert_row(want: dict, got: dict, n_ties: int, n_queries: int) -> None:
    """One row: the same keys; metrics within ``n_ties / n_queries``
    (+ FLOAT), everything else equal."""
    assert set(got) == set(want)
    for key, w in want.items():
        if key in METRICS:
            assert abs(got[key] - w) <= n_ties / n_queries + FLOAT, \
                (key, w, got[key], n_ties)
        else:
            assert got[key] == w, (key, w, got[key])


def assert_points(want, got, n_ties: list, n_queries: int) -> None:
    """Curves of (cost, recall) points (Figures 3 and 4): the costs equal
    (the mean candidates), recall as :func:`assert_row`'s."""
    assert list(got) == list(want)
    ties = iter(n_ties)
    for name in want:
        assert len(got[name]) == len(want[name])
        for (cost_w, rec_w), (cost_g, rec_g) in zip(want[name], got[name]):
            assert cost_g == cost_w, (name, cost_w, cost_g)
            assert abs(rec_g - rec_w) <= next(ties) / n_queries + FLOAT, \
                (name, rec_w, rec_g)


def reference_dicts(path: str, func: str, **env) -> tuple:
    """(the key sets of every dict literal in the reference function
    ``func`` of ``path``, {name: the keys of every ``name[key] = ...``}),
    f-string keys formatted with ``env``."""
    def key(node):
        if isinstance(node, ast.Constant):
            return node.value
        return "".join(v.value if isinstance(v, ast.Constant)
                       else str(env[v.value.id]) for v in node.values)

    tree = ast.parse(open(path).read())
    fn = next(n for n in ast.walk(tree)
              if isinstance(n, ast.FunctionDef) and n.name == func)
    literals = [{key(k) for k in n.keys} for n in ast.walk(fn)
                if isinstance(n, ast.Dict)]
    assigned = {}
    for n in ast.walk(fn):
        t = n.targets[0] if isinstance(n, ast.Assign) else None
        if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name):
            assigned.setdefault(t.value.id, set()).add(key(t.slice))
    return literals, assigned
