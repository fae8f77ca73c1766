"""The port's serving runtime (``repro_torch.launch.runtime``, DESIGN.md
§10) on the CPU: the single-rung contracts of ``tests/test_runtime.py``
on port-built indexes, its adaptive cases (DESIGN.md §14: one program
per (bucket, rung), rows bitwise at the resolved rung, no cross-rung
cache replay, the metrics lines), every bucket bit-identical to ``Server.query``
for every codec dense and fused, and two parity tests on an index the
JAX package built and saved with ``save_index``: the reference runtime's
rows against the port runtime's (DESIGN.md §11: ids exact apart from
near-tie swaps, scores within rtol=atol=1e-4) and the port runtime's
against the port's own ``Server.query`` bit for bit.

Every wait on a future has a timeout, so a hang fails one test.  The
indexes are built once per module; mutable servers are restored from one
built state, so each test mutates its own copy.
"""
import gc
import inspect
import threading

import numpy as np
import pytest
import torch

from repro_torch.core import exec as qexec
from repro_torch.core import hybrid_index as hi
from repro_torch.core import segments as seg
from repro_torch.core.exec import frontier
from repro_torch.data import synthetic
from repro_torch.launch import runtime as rt_mod
from repro_torch.launch import serve

torch.set_num_threads(2)

WAIT = 120            # seconds any one future may take
TOL = 1e-4            # DESIGN.md §11
_KW = dict(n_clusters=16, k1_terms=4, codec="pq", pq_m=4, pq_k=64,
           cluster_capacity=64, term_capacity=32, kmeans_iters=3)
HOLD = 64


@pytest.fixture(scope="module")
def c():
    return synthetic.generate(seed=0, n_docs=1400, n_queries=24, hidden=32,
                              vocab_size=512, n_topics=8)


@pytest.fixture(scope="module")
def built(c):
    """The plain, namespaced and mutable indexes, built once."""
    ns = np.arange(c.doc_emb.shape[0]) % 4
    plain = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                     device="cpu", **_KW)
    filtered = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                        doc_namespaces=ns, device="cpu", **_KW)
    mut = seg.MutableHybridIndex.create(
        0, c.doc_emb[:-HOLD], c.doc_tokens[:-HOLD], c.vocab_size,
        delta_capacity=HOLD, device="cpu", **_KW)
    return {"plain": plain, "filtered": filtered, "mut": mut}


def _plain_server(built, max_batch=16, n_namespaces=0):
    idx = built["filtered" if n_namespaces else "plain"]
    return serve.make_server(idx, serve.ServeConfig(
        max_batch=max_batch, n_namespaces=n_namespaces), device="cpu")


def _fresh_mut(built):
    m = built["mut"]
    return seg.MutableHybridIndex.from_state(m.state_tree(), m.state_extra(),
                                             seed=m.seed)


def _mutable_server(built, max_batch=16, **cfg):
    return serve.make_mutable_server(_fresh_mut(built), serve.ServeConfig(
        max_batch=max_batch, mutable=True, **cfg), device="cpu")


def _runtime(server, c, **cfg):
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(**cfg))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    return rt


def _rows_equal(row, batch_res, i):
    np.testing.assert_array_equal(np.asarray(row.doc_ids),
                                  np.asarray(batch_res.doc_ids)[i])
    np.testing.assert_array_equal(np.asarray(row.scores),
                                  np.asarray(batch_res.scores)[i])
    assert int(row.n_candidates) == int(
        np.asarray(batch_res.n_candidates)[i])


def _batch_equal(a, b, n=None):
    for name in ("doc_ids", "scores", "n_candidates"):
        np.testing.assert_array_equal(np.asarray(getattr(a, name))[:n],
                                      np.asarray(getattr(b, name))[:n])


# --------------------------------------------------------------------------
# bit-identity: runtime rows == Server.query rows, cached and uncached
# --------------------------------------------------------------------------

def test_runtime_rows_bit_identical_to_server_query(built, c):
    server = _plain_server(built)
    direct = server.query(c.query_emb[:8], c.query_tokens[:8])
    with _runtime(server, c) as rt:
        futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
                   for i in range(8)]
        for i, f in enumerate(futures):
            _rows_equal(f.result(timeout=WAIT), direct, i)
        # the batched convenience wrapper reassembles the same rows
        again = rt.query(c.query_emb[:8], c.query_tokens[:8], timeout=WAIT)
        _batch_equal(again, direct)


def test_runtime_filtered_rows_bit_identical(built, c):
    server = _plain_server(built, n_namespaces=4)
    want = [i % 4 for i in range(8)]
    direct = server.query(c.query_emb[:8], c.query_tokens[:8],
                          namespaces=want)
    with _runtime(server, c) as rt:
        got = rt.query(c.query_emb[:8], c.query_tokens[:8],
                       namespaces=want, timeout=WAIT)
        _batch_equal(got, direct)
        # unfiltered requests on a namespaced server ride an allow-all
        # bitmap row, a bitwise no-op against Server.query's filter=None
        plain = server.query(c.query_emb[:8], c.query_tokens[:8])
        _batch_equal(rt.query(c.query_emb[:8], c.query_tokens[:8],
                              timeout=WAIT), plain)


def test_cache_hit_is_bit_identical_and_epoch_bump_invalidates(built, c):
    server = _mutable_server(built)
    with _runtime(server, c, cache_size=64) as rt:
        first = rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        hits0 = rt.cache.hits
        again = rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        assert rt.cache.hits == hits0 + 4
        _batch_equal(first, again)
        # cached rows equal a fresh direct query
        direct = server.query(c.query_emb[:4], c.query_tokens[:4])
        _batch_equal(again, direct)
        # a mutation bumps the epoch: the same queries miss and run
        # against the mutated index
        epoch0 = server.epoch
        rt.add(c.doc_emb[-16:], c.doc_tokens[-16:])
        assert server.epoch == epoch0 + 1
        hits1, misses1 = rt.cache.hits, rt.cache.misses
        post = rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        assert rt.cache.hits == hits1         # no stale replay
        assert rt.cache.misses == misses1 + 4
        _batch_equal(post, server.query(c.query_emb[:4],
                                        c.query_tokens[:4]))


def test_compaction_through_runtime_rewarms_off_the_request_path(built, c):
    """compact() makes a new index: its one new program per bucket lands
    in the runtime's re-warm, never on the next request of a bucket."""
    server = _mutable_server(built)
    with _runtime(server, c, cache_size=16) as rt:
        rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        rt.add(c.doc_emb[-8:], c.doc_tokens[-8:])
        before = qexec.trace_count()
        rt.compact()
        assert qexec.trace_count() - before == len(rt.buckets)
        post = rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        assert rt.serve_traces == 0            # requests never build
        rt.assert_one_compile_per_bucket()
        _batch_equal(post, server.query(c.query_emb[:4],
                                        c.query_tokens[:4]))


def test_warmup_revives_a_closed_runtime(built, c):
    server = _plain_server(built)
    rt = _runtime(server, c)
    first = rt.query(c.query_emb[:2], c.query_tokens[:2], timeout=WAIT)
    rt.close(drain=True)
    with pytest.raises(rt_mod.RuntimeClosed):
        rt.submit(c.query_emb[0], c.query_tokens[0])
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    again = rt.query(c.query_emb[:2], c.query_tokens[:2], timeout=WAIT)
    np.testing.assert_array_equal(first.doc_ids, again.doc_ids)
    rt.close()


def test_warmup_freezes_the_objects_alive_at_warmup(built, c):
    """The objects alive when warmup has built its programs leave the
    collector's generations (``gc.freeze``), so a full collection while
    serving scans only what serving made; the rows stay bit-identical
    to ``Server.query``'s."""
    server = _plain_server(built)
    direct = server.query(c.query_emb[:8], c.query_tokens[:8])
    alive = [object()]           # a tracked object made before warmup
    gc.unfreeze()
    try:
        before = gc.get_freeze_count()
        with _runtime(server, c) as rt:
            assert gc.get_freeze_count() > before
            assert not any(o is alive for o in gc.get_objects())
            futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
                       for i in range(8)]
            for i, f in enumerate(futures):
                _rows_equal(f.result(timeout=WAIT), direct, i)
    finally:
        gc.unfreeze()


def test_done_callback_may_reenter_submit(built, c):
    """A done-callback (run on the resolving thread, possibly the
    scheduler) that submits a follow-up query must not deadlock."""
    server = _plain_server(built)
    with _runtime(server, c, cache_size=8) as rt:
        chained, attached = [], threading.Event()

        def follow_up(_):
            chained.append(rt.submit(c.query_emb[1], c.query_tokens[1]))
            attached.set()

        f = rt.submit(c.query_emb[0], c.query_tokens[0])
        f.add_done_callback(follow_up)
        f.result(timeout=WAIT)
        assert attached.wait(timeout=WAIT)
        direct = server.query(c.query_emb[:2], c.query_tokens[:2])
        _rows_equal(chained[0].result(timeout=WAIT), direct, 1)


def test_epoch_counter_semantics(built, c):
    server = _mutable_server(built)
    assert server.epoch == 0
    ids = server.add(c.doc_emb[-8:], c.doc_tokens[-8:])
    assert server.epoch == 1
    server.delete(ids[:2])
    assert server.epoch == 2
    server.compact()
    assert server.epoch == 3     # compaction renumbers -> must invalidate
    assert _plain_server(built).epoch == 0   # immutable: never invalidates
    # the counter travels with the state: a restored index keeps
    # invalidating epoch-keyed caches where the saved one left off
    mut = server.mut
    back = seg.MutableHybridIndex.from_state(mut.state_tree(),
                                             mut.state_extra(), seed=0)
    assert back.epoch == mut.epoch == 3


def test_cancelled_future_does_not_poison_the_batch(built, c):
    """A client that cancel()s while queued neither receives a result
    nor breaks its co-riders."""
    server = _plain_server(built, max_batch=4)
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(linger_ms=300.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
               for i in range(3)]
    cancelled = futures[1].cancel()    # still queued (300 ms linger)
    rt.close(drain=True)
    direct = server.query(c.query_emb[:4], c.query_tokens[:4])
    for i in (0, 2):
        _rows_equal(futures[i].result(timeout=WAIT), direct, i)
    if cancelled:                      # raced the scheduler: either way,
        assert futures[1].cancelled()  # the future is terminal
    else:
        _rows_equal(futures[1].result(timeout=WAIT), direct, 1)


def test_concurrent_clients_each_get_their_own_rows(built, c):
    """More client threads than cores submit at once, with the switch
    interval cut to force interleavings: every future resolves to its own
    query's rows, and the counters lose no update (each request counted
    once, as served or as a cache hit)."""
    import sys
    server = _plain_server(built)
    direct = server.query(c.query_emb[:16], c.query_tokens[:16])
    n_threads, per_thread = 16, 12
    got, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with _runtime(server, c, cache_size=8, queue_depth=1024) as rt:
            def client(t):
                try:
                    for k in range(per_thread):
                        i = (t + k) % 16
                        row = rt.submit(c.query_emb[i], c.query_tokens[i]
                                        ).result(timeout=WAIT)
                        got[(t, k)] = (i, row)
                except BaseException as e:      # noqa: BLE001 — reported
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            assert rt.n_served + rt.cache.hits == n_threads * per_thread
            assert rt.n_rejected == 0
    finally:
        sys.setswitchinterval(old)
    assert len(got) == n_threads * per_thread
    for i, row in got.values():
        _rows_equal(row, direct, i)


# --------------------------------------------------------------------------
# program accounting: one program per bucket, none after warmup
# --------------------------------------------------------------------------

def test_one_compile_per_bucket_and_none_while_serving(built, c):
    # odd max_batch: the ladder must top out at max_batch itself
    server = _plain_server(built, max_batch=12)
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig())
    assert rt.buckets == (1, 2, 4, 8, 12)
    before = qexec.trace_count()
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    # exactly one program per bucket (the port builds each one, always)
    assert rt.warm_traces == {b: 1 for b in rt.buckets}
    assert qexec.trace_count() - before == len(rt.buckets)
    with rt:
        for n in (1, 3, 5, 12, 7, 2):
            rt.query(c.query_emb[:n], c.query_tokens[:n], timeout=WAIT)
        assert rt.serve_traces == 0
        rt.assert_one_compile_per_bucket()
        # every request landed in a warmed bucket
        assert sum(rt.bucket_counts.values()) == rt.n_batches


def test_bucket_ladder_shapes():
    assert rt_mod.MIN_BUCKET == 1
    assert rt_mod.bucket_sizes(64) == (1, 2, 4, 8, 16, 32, 64)
    assert rt_mod.bucket_sizes(48) == (1, 2, 4, 8, 16, 32, 48)
    assert rt_mod.bucket_sizes(2) == (1, 2)
    assert rt_mod.bucket_sizes(1) == (1,)
    assert rt_mod.bucket_sizes(64, min_bucket=2) == (2, 4, 8, 16, 32, 64)
    assert rt_mod.bucket_sizes(8, min_bucket=4) == (4, 8)
    with pytest.raises(ValueError):
        rt_mod.bucket_sizes(0)


def test_bucket_ladder_quantum():
    """The batch quantum of a 2-D mesh server (DESIGN.md §12): every
    rung splits into equal per-replica row blocks (the reference's
    cases, from the port's 1-row minimum)."""
    assert rt_mod.bucket_sizes(64, quantum=2) == (2, 4, 8, 16, 32, 64)
    assert rt_mod.bucket_sizes(64, min_bucket=2, quantum=2) == (
        4, 8, 16, 32, 64)
    assert rt_mod.bucket_sizes(32, quantum=4) == (4, 8, 16, 32)
    assert rt_mod.bucket_sizes(32, min_bucket=2, quantum=4) == (8, 16, 32)
    assert rt_mod.bucket_sizes(4, quantum=4) == (4,)
    assert rt_mod.bucket_sizes(12, quantum=3) == (3, 6, 12)
    with pytest.raises(ValueError, match="quantum"):
        rt_mod.bucket_sizes(30, quantum=4)


class _FakeMeshServer:
    """What the runtime reads of a 4-replica server before warmup."""

    class cfg:
        max_batch = 32
        n_namespaces = 3

    n_replicas = 4
    rungs = ((6, 8),)
    margin_cuts = ()


def test_runtime_quantum_and_row_placement_follow_the_replicas():
    """Buckets are multiples of the server's replica count, and request
    i of a batch rides row (i % D)·bucket/D + i // D: injective,
    round-robin over the replicas' contiguous row blocks; the namespace
    bitmap follows the rows, and unplaced rows match nothing."""
    rt = rt_mod.ServingRuntime(_FakeMeshServer())
    assert rt.n_replicas == 4 and rt.buckets == (4, 8, 16, 32)
    assert rt.replica_dispatch == {0: 0, 1: 0, 2: 0, 3: 0}
    assert rt._rows_idx(6, 8) == [0, 2, 4, 6, 1, 3]
    assert rt._rows_idx(5, 8)[:4] == [0, 2, 4, 6]
    for n, b in ((1, 4), (7, 8), (32, 32), (9, 16)):
        place = rt._rows_idx(n, b)
        assert len(set(place)) == n and max(place) < b
        # replica r holds rows [r·b/4, (r+1)·b/4): a request per replica
        # before any gets a second
        assert [p // (b // 4) for p in place[:4]] == list(range(min(n, 4)))
    bitmap = rt._bitmap([None, (1,), (0, 2)], 8, rt._rows_idx(3, 8))
    want = np.zeros((8, 1), np.int64)
    want[0], want[2], want[4] = 0b111, 0b010, 0b101
    np.testing.assert_array_equal(bitmap, want)
    # the 1-D default is the identity
    plain = rt._bitmap([None, (1,), (0, 2)], 4)
    np.testing.assert_array_equal(plain[:3, 0], [0b111, 0b010, 0b101])
    assert not plain[3].any()


# --------------------------------------------------------------------------
# admission control: FIFO under backpressure, fail-fast rejection
# --------------------------------------------------------------------------

def test_fifo_completion_under_backpressure(built, c):
    server = _plain_server(built, max_batch=4)
    rt = rt_mod.ServingRuntime(
        server, rt_mod.RuntimeConfig(queue_depth=6, linger_ms=50.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    done_order = []
    lock = threading.Lock()

    def _track(i):
        def cb(_):
            with lock:
                done_order.append(i)
        return cb

    accepted, rejected = [], 0
    for i in range(24):
        try:
            f = rt.submit(c.query_emb[i % 24], c.query_tokens[i % 24])
        except rt_mod.RuntimeOverloaded as e:
            rejected += 1
            assert e.retry_after_ms > 0
            continue
        f.add_done_callback(_track(i))
        accepted.append((i, f))
    for _, f in accepted:
        f.result(timeout=WAIT)
    assert rejected > 0                    # depth 6 must push back on 24
    assert rt.n_rejected == rejected
    # accepted requests complete in submission order
    assert done_order == [i for i, _ in accepted]
    rt.close()


def test_query_rows_enter_one_micro_batch(built, c):
    # query() queues its rows under one hold of the lock: even with no
    # linger the scheduler sees all 32 together and runs one batch
    server = _plain_server(built, max_batch=32)
    qe = np.concatenate([c.query_emb, c.query_emb[:8]])
    qt = np.concatenate([c.query_tokens, c.query_tokens[:8]])
    direct = server.query(qe, qt)
    with _runtime(server, c, linger_ms=0.0) as rt:
        got = rt.query(qe, qt, timeout=WAIT)
        s = rt.stats()
    assert s["n_batches"] == 1 and s["bucket_counts"][32] == 1
    _batch_equal(got, direct)


def test_query_admission_takes_or_rejects_the_batch_whole(built, c):
    server = _plain_server(built, max_batch=16)
    rt = rt_mod.ServingRuntime(
        server, rt_mod.RuntimeConfig(queue_depth=16, linger_ms=5000.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    # more rows than the queue holds never fit: not a retry
    with pytest.raises(ValueError, match="queue_depth=16"):
        rt.query(c.query_emb[:17], c.query_tokens[:17], timeout=WAIT)
    # the long linger holds 8 single requests in the queue; 9 more rows
    # do not fit beside them, and none of the 9 is queued
    futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
               for i in range(8)]
    with pytest.raises(rt_mod.RuntimeOverloaded):
        rt.query(c.query_emb[8:17], c.query_tokens[8:17], timeout=WAIT)
    s = rt.stats()
    assert s["n_rejected"] == 9 and s["n_batches"] == 0
    rt.close(drain=True)
    direct = server.query(c.query_emb[:8], c.query_tokens[:8])
    for i, f in enumerate(futures):
        _rows_equal(f.result(timeout=WAIT), direct, i)
    with _runtime(server, c, queue_depth=16, linger_ms=0.0) as rt:
        got = rt.query(c.query_emb[:16], c.query_tokens[:16], timeout=WAIT)
    _batch_equal(got, server.query(c.query_emb[:16], c.query_tokens[:16]))


def test_graceful_drain_leaves_no_dropped_requests(built, c):
    server = _plain_server(built, max_batch=4)
    rt = rt_mod.ServingRuntime(
        server, rt_mod.RuntimeConfig(queue_depth=64, linger_ms=200.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    # long linger: the queue still holds requests when close() lands
    futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
               for i in range(16)]
    rt.close(drain=True)
    direct = [server.query(c.query_emb[i:i + 4], c.query_tokens[i:i + 4])
              for i in range(0, 16, 4)]
    for i, f in enumerate(futures):
        assert f.done()
        _rows_equal(f.result(timeout=WAIT), direct[i // 4], i % 4)
    with pytest.raises(rt_mod.RuntimeClosed):
        rt.submit(c.query_emb[0], c.query_tokens[0])


def test_close_without_drain_fails_pending_futures(built, c):
    server = _plain_server(built, max_batch=4)
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig(linger_ms=500.0))
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
               for i in range(6)]
    rt.close(drain=False)
    outcomes = []
    for f in futures:
        assert f.done()
        try:
            f.result(timeout=WAIT)
            outcomes.append("ok")
        except rt_mod.RuntimeClosed:
            outcomes.append("closed")
    # every future resolved one way or the other; a 500 ms linger keeps
    # at least the tail pending
    assert "closed" in outcomes


def test_submit_validation(built, c):
    server = _plain_server(built)                    # unfiltered
    rt = rt_mod.ServingRuntime(server, rt_mod.RuntimeConfig())
    with pytest.raises(rt_mod.RuntimeClosed, match="warmup"):
        rt.submit(c.query_emb[0], c.query_tokens[0])
    rt.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    with rt:
        with pytest.raises(ValueError, match="namespaces"):
            rt.submit(c.query_emb[0], c.query_tokens[0], namespaces=1)
        with pytest.raises(ValueError, match="shapes"):
            rt.submit(c.query_emb[0][:8], c.query_tokens[0])
    # an out-of-range tenant id fails ITS request at submit, never a
    # whole batch in the scheduler
    server_ns = _plain_server(built, n_namespaces=4)
    with _runtime(server_ns, c) as rt:
        good = rt.submit(c.query_emb[0], c.query_tokens[0], namespaces=2)
        with pytest.raises(ValueError, match="out of range"):
            rt.submit(c.query_emb[1], c.query_tokens[1], namespaces=99)
        assert good.result(timeout=WAIT).doc_ids.shape[0] > 0


# --------------------------------------------------------------------------
# normalized cache keys: scale-invariant hits, tenant/epoch safety
# --------------------------------------------------------------------------

def test_cache_key_normalization_scaled_query_hits(built, c):
    server = _plain_server(built)
    with _runtime(server, c, cache_size=32) as rt:
        row = rt.submit(c.query_emb[0], c.query_tokens[0]).result(
            timeout=WAIT)
        hits0 = rt.cache.hits
        scaled = rt.submit(np.float32(3.7) * c.query_emb[0],
                           c.query_tokens[0]).result(timeout=WAIT)
        assert rt.cache.hits == hits0 + 1
        np.testing.assert_array_equal(row.doc_ids, scaled.doc_ids)
        np.testing.assert_array_equal(row.scores, scaled.scores)
    # distinct queries map to distinct keys at the documented quantum
    keys = {rt_mod._canon_qe(np.asarray(c.query_emb[i], np.float32))
            for i in range(c.query_emb.shape[0])}
    assert len(keys) == c.query_emb.shape[0]
    assert rt_mod._canon_qe(np.zeros(32, np.float32)) is not None


def test_cache_no_false_hits_across_tenants_or_mutations(built, c):
    server = _plain_server(built, n_namespaces=4)
    with _runtime(server, c, cache_size=64) as rt:
        a = rt.submit(c.query_emb[0], c.query_tokens[0],
                      namespaces=0).result(timeout=WAIT)
        hits0 = rt.cache.hits
        b = rt.submit(c.query_emb[0], c.query_tokens[0],
                      namespaces=1).result(timeout=WAIT)
        assert rt.cache.hits == hits0          # different tenant: no hit
        assert (a.doc_ids[a.doc_ids >= 0] % 4 == 0).all()
        assert (b.doc_ids[b.doc_ids >= 0] % 4 == 1).all()
        again = rt.submit(np.float32(2.0) * c.query_emb[0],
                          c.query_tokens[0], namespaces=0).result(
                              timeout=WAIT)
        assert rt.cache.hits == hits0 + 1
        np.testing.assert_array_equal(a.doc_ids, again.doc_ids)
    with _runtime(_mutable_server(built), c, cache_size=64) as rt:
        rt.submit(c.query_emb[0], c.query_tokens[0]).result(timeout=WAIT)
        rt.add(c.doc_emb[-8:], c.doc_tokens[-8:])
        hits0 = rt.cache.hits
        rt.submit(np.float32(2.0) * c.query_emb[0],
                  c.query_tokens[0]).result(timeout=WAIT)
        assert rt.cache.hits == hits0          # epoch bumped: no replay


# --------------------------------------------------------------------------
# metrics endpoint: stats() scrape-able as plaintext over HTTP
# --------------------------------------------------------------------------

def test_metrics_endpoint_serves_runtime_stats(built, c):
    import urllib.error
    import urllib.request

    server = _plain_server(built)
    with _runtime(server, c, cache_size=8) as rt:
        rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        with rt.serve_metrics(port=0) as metrics:
            url = f"http://127.0.0.1:{metrics.port}/metrics"
            body = urllib.request.urlopen(url, timeout=10).read().decode()
            assert "hi2_runtime_served_total 4" in body
            assert "hi2_runtime_queue_depth 0" in body
            assert "hi2_runtime_replicas 1" in body
            assert 'hi2_runtime_bucket_compiles{bucket="4"} 1' in body
            assert "hi2_runtime_cache_hits_total 4" in body
            assert "hi2_runtime_cache_hit_rate 0.5" in body
            assert 'hi2_runtime_replica_dispatch_total{replica="0"} 4' \
                in body
            with pytest.raises(urllib.error.HTTPError):
                urllib.request.urlopen(
                    f"http://127.0.0.1:{metrics.port}/other", timeout=10)
        text = rt_mod.render_metrics(rt.stats())
        assert text.endswith("\n") and "hi2_runtime_batches_total" in text
    with _runtime(_plain_server(built), c) as rt2:
        s = rt2.stats()
        assert s["cache"] is None and s["queue_depth"] == 0
        assert s["graph_pool_bytes"] is None        # no graphs on the CPU
        assert "hi2_runtime_cache_hits_total" not in rt_mod.render_metrics(s)


# --------------------------------------------------------------------------
# auto-compaction watermarks (DESIGN.md §8): off by default, bit-identical
# --------------------------------------------------------------------------

def test_auto_compaction_is_off_by_default(built, c):
    server = _mutable_server(built)
    server.add(c.doc_emb[-HOLD:], c.doc_tokens[-HOLD:])  # delta 100% full
    assert server.mut.delta_count == HOLD                # never compacted


def test_auto_compaction_fill_watermark_bit_identical(built, c):
    auto = _mutable_server(built, compact_fill_watermark=0.5)
    manual = _mutable_server(built)                    # watermarks off
    for lo in (64, 48, 32, 16):                        # 4 adds of 16
        auto.add(c.doc_emb[-lo:][:16], c.doc_tokens[-lo:][:16])
        manual.add(c.doc_emb[-lo:][:16], c.doc_tokens[-lo:][:16])
        if manual.mut.needs_compact(fill_watermark=0.5):
            manual.compact()
    assert auto.mut.delta_count < HOLD                 # it did compact
    _batch_equal(auto.query(c.query_emb[:8], c.query_tokens[:8]),
                 manual.query(c.query_emb[:8], c.query_tokens[:8]))


def test_auto_compaction_tombstone_watermark(built, c):
    server = _mutable_server(built, compact_tombstone_watermark=0.02)
    n0 = server.mut.n_base
    assert server.mut.tombstone_ratio == 0.0
    server.delete(np.arange(40))                       # ~3% of 1336 docs
    # the delete crossed the watermark and compacted the survivors away
    assert server.mut.n_deleted == 0
    assert server.mut.n_base == n0 - 40
    ids = server.query(c.query_emb[:8], c.query_tokens[:8]).doc_ids.numpy()
    assert (ids[ids >= 0] < server.mut.n_base).all()


def test_single_rung_ledger_and_metrics_keep_baseline_shape(built, c):
    """One rung: the warm ledger keys stay plain bucket ints and the
    bucket_compiles metric keeps the reference's single-rung labels."""
    server = _plain_server(built, max_batch=8)
    with _runtime(server, c) as rt:
        assert rt.rungs == ((server.kc, server.k2),) == server.rungs
        assert all(isinstance(k, int) for k in rt.warm_traces)
        body = rt_mod.render_metrics(rt.stats())
        assert 'hi2_runtime_bucket_compiles{bucket="2"} ' in body
        assert 'rung=' not in body.split("rung_dispatch")[0].split(
            "width_info")[0]


def test_auto_compaction_through_runtime_rewarms(built, c):
    """A watermark compaction fired by a runtime add() swaps the base
    index; the runtime builds its buckets again, off the request path."""
    server = _mutable_server(built, compact_fill_watermark=0.25)
    with _runtime(server, c, cache_size=16) as rt:
        rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        base0 = server.index
        rt.add(c.doc_emb[-32:], c.doc_tokens[-32:])    # fill 0.5 >= 0.25
        assert server.index is not base0               # auto-compacted
        post = rt.query(c.query_emb[:4], c.query_tokens[:4], timeout=WAIT)
        assert rt.serve_traces == 0
        rt.assert_one_compile_per_bucket()
        _batch_equal(post, server.query(c.query_emb[:4],
                                        c.query_tokens[:4]))


# --------------------------------------------------------------------------
# adaptive width rungs (DESIGN.md §14): programs, cache keys, metrics
# --------------------------------------------------------------------------

def _ladder(index, c):
    """A hand-calibrated 2-rung record over ``index``: the median margin
    of the sample as the cut, so both rungs see traffic."""
    m = frontier.margins(index.cluster_sel.embeddings, c.query_emb)
    return frontier.TunedWidths(
        kc=4, k2=4, refine_mult=None, recall_target=0.9, recall=0.9,
        cost=int(hi.candidate_budget(index, 4, 4)),
        rungs=((2, 2), (4, 4)), margin_cuts=(float(np.median(m)),))


def _adaptive_runtime(built, c, max_batch=8, **cfg):
    idx = built["plain"]
    server = serve.make_server(hi.with_tuned(idx, _ladder(idx, c)),
                               serve.ServeConfig(adaptive=True,
                                                 max_batch=max_batch),
                               device="cpu")
    return server, _runtime(server, c, **cfg)


def _resolved_rungs(server, qe):
    return frontier.resolve_rung(
        frontier.margins(server.index.cluster_sel.embeddings, qe),
        server.margin_cuts)


def test_adaptive_one_program_per_bucket_rung_and_bit_identity(built, c):
    """Warmup builds exactly one program per (bucket, rung), serving
    builds none, and every row equals the direct search at its resolved
    rung's widths, bit for bit."""
    server, rt = _adaptive_runtime(built, c)
    assert server.width_source == "tuned"
    assert rt.rungs == ((2, 2), (4, 4))
    assert set(rt.warm_traces) == {(b, r) for b in rt.buckets
                                   for r in range(2)}
    assert set(rt.warm_traces.values()) == {1}
    assert set(rt._programs) == set(rt.warm_traces)
    with rt:
        futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
                   for i in range(24)]
        rows = [f.result(timeout=WAIT) for f in futures]
        assert rt.serve_traces == 0
        rt.assert_one_compile_per_bucket()
        assert all(rt.rung_dispatch[r] > 0 for r in range(2)), \
            rt.rung_dispatch
        assert sum(rt.rung_dispatch.values()) == 24
        rung = _resolved_rungs(server, c.query_emb[:24])
        for r, (kc, k2) in enumerate(rt.rungs):
            ref = hi.search(server.index, c.query_emb[:24],
                            c.query_tokens[:24], kc=kc, k2=k2,
                            top_r=server.cfg.top_r, device="cpu")
            for i in np.nonzero(rung == r)[0]:
                _rows_equal(rows[i], ref, i)


def test_adaptive_rungs_equal_the_reference_rule(built, c):
    """The runtime's rung per request is frontier.resolve_rung of the
    float64 margin against the embeddings it holds (one float64 copy per
    ladder refresh), the reference's margins on the same inputs."""
    from repro.core.exec import frontier as jfrontier
    server, rt = _adaptive_runtime(built, c)
    with rt:
        assert rt._cluster_emb.dtype == np.float64
        emb = server.index.cluster_sel.embeddings.numpy()
        np.testing.assert_array_equal(rt._cluster_emb, emb)
        want = jfrontier.resolve_rung(
            jfrontier.margins(emb, c.query_emb), server.margin_cuts)
        got = [rt._rung_for(c.query_emb[i]) for i in range(len(want))]
        np.testing.assert_array_equal(got, want)
        # positive rescaling resolves the same rung
        assert [rt._rung_for(np.float32(4.0) * c.query_emb[i])
                for i in range(len(want))] == got


def test_adaptive_batches_carry_one_rung(built, c):
    """Co-rung micro-batching: requests queued together split into
    batches of one rung each, FIFO within a rung."""
    server, rt = _adaptive_runtime(built, c, linger_ms=100.0)
    rung = _resolved_rungs(server, c.query_emb[:16])
    seen = []
    orig = rt._run_batch

    def spy(misses, r, epoch, rows):
        seen.append((r, [int(np.flatnonzero(
            (c.query_emb[:16] == m.qe).all(1))[0]) for m in misses]))
        return orig(misses, r, epoch, rows)

    rt._run_batch = spy
    with rt:
        futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
                   for i in range(16)]
        for f in futures:
            f.result(timeout=WAIT)
    for r, idxs in seen:
        assert all(rung[i] == r for i in idxs), (r, idxs)
        assert idxs == sorted(idxs)
    assert sorted(i for _, idxs in seen for i in idxs) == list(range(16))
    assert {r for r, _ in seen} == {0, 1}


def test_adaptive_concurrent_clients_each_get_their_rung_rows(built, c):
    """More client threads than cores submit to an adaptive runtime with
    the switch interval cut: every row is its query's at its rung, and
    the per-rung counters lose no update."""
    import sys
    server, rt = _adaptive_runtime(built, c, cache_size=8,
                                   queue_depth=1024)
    rung = _resolved_rungs(server, c.query_emb[:16])
    want = [hi.search(server.index, c.query_emb[:16], c.query_tokens[:16],
                      kc=kc, k2=k2, top_r=server.cfg.top_r, device="cpu")
            for kc, k2 in rt.rungs]
    n_threads, per_thread = 12, 10
    got, errors = {}, []
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with rt:
            def client(t):
                try:
                    for k in range(per_thread):
                        i = (3 * t + k) % 16
                        got[(t, k)] = (i, rt.submit(
                            c.query_emb[i], c.query_tokens[i]).result(
                                timeout=WAIT))
                except BaseException as e:      # noqa: BLE001 — reported
                    errors.append(e)

            threads = [threading.Thread(target=client, args=(t,))
                       for t in range(n_threads)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=WAIT)
            assert not any(t.is_alive() for t in threads)
            assert not errors, errors
            assert (sum(rt.rung_dispatch.values()) + rt.cache.hits
                    == rt.n_served + rt.cache.hits
                    == n_threads * per_thread)
            assert rt.serve_traces == 0
    finally:
        sys.setswitchinterval(old)
    assert len(got) == n_threads * per_thread
    for i, row in got.values():
        _rows_equal(row, want[rung[i]], i)


def test_adaptive_cache_key_separates_rungs_and_replays_within(built, c):
    server, rt = _adaptive_runtime(built, c, cache_size=64)
    with rt:
        q0 = np.asarray(c.query_emb[0], np.float32)
        t0 = np.asarray(c.query_tokens[0], np.int64)
        # a margin flip at a cut can only miss, never replay a row
        # computed at the other rung's widths
        assert rt._key(q0, t0, None, 0) != rt._key(q0, t0, None, 1)
        first = rt.submit(q0, t0).result(timeout=WAIT)
        hits0 = rt.cache.hits
        again = rt.submit(np.float32(2.0) * q0, t0).result(timeout=WAIT)
        assert rt.cache.hits == hits0 + 1
        np.testing.assert_array_equal(first.doc_ids, again.doc_ids)
        # a row cached at one rung is not served to the other rung
        r0 = rt._rung_for(q0)
        rt.cache.put(rt._key(q0, t0, None, 1 - r0), "other rung")
        assert rt.submit(q0, t0).result(timeout=WAIT) is first


def test_metrics_expose_width_info_and_rung_dispatch(built, c):
    server, rt = _adaptive_runtime(built, c)
    with rt:
        rt.query(c.query_emb[:8], c.query_tokens[:8], timeout=WAIT)
        stats = rt.stats()
        body = rt_mod.render_metrics(stats)
    assert stats["rungs"] == [[2, 2], [4, 4]]
    assert sum(stats["rung_dispatch"].values()) == 8
    assert 'hi2_runtime_width_info{source="tuned",kc="4",k2="4"} 1' in body
    assert "hi2_runtime_rungs 2" in body
    assert 'hi2_runtime_rung_dispatch_total{rung="0",kc="2",k2="2"} ' in body
    assert 'hi2_runtime_rung_dispatch_total{rung="1",kc="4",k2="4"} ' in body
    assert 'hi2_runtime_bucket_compiles{bucket="2",rung="0"} 1' in body


def test_adaptive_mutable_server_keeps_its_ladder_across_compaction(built,
                                                                    c):
    """MutableServer resolves its widths from the tuned base once; the
    compacted base carries no record, yet the ladder stays and the
    runtime refreshes its margin embeddings from the new base."""
    mut = _fresh_mut(built)
    mut.base = hi.with_tuned(mut.base, _ladder(mut.base, c))
    server = serve.make_mutable_server(mut, serve.ServeConfig(
        max_batch=8, mutable=True, adaptive=True), device="cpu")
    with _runtime(server, c) as rt:
        assert rt.rungs == ((2, 2), (4, 4))
        rt.add(c.doc_emb[-16:], c.doc_tokens[-16:])
        rt.compact()
        assert server.index.tuned is None
        assert server.rungs == ((2, 2), (4, 4)) and rt.rungs == server.rungs
        np.testing.assert_array_equal(
            rt._cluster_emb, server.index.cluster_sel.embeddings.numpy())
        rows = rt.query(c.query_emb[:8], c.query_tokens[:8], timeout=WAIT)
        assert rt.serve_traces == 0
        rung = _resolved_rungs(server, c.query_emb[:8])
        for r, (kc, k2) in enumerate(rt.rungs):
            ref = server.mut.search(c.query_emb[:8], c.query_tokens[:8],
                                    kc=kc, k2=k2, top_r=server.cfg.top_r)
            for i in np.nonzero(rung == r)[0]:
                np.testing.assert_array_equal(rows.doc_ids[i],
                                              ref.doc_ids[i].numpy())
                np.testing.assert_array_equal(rows.scores[i],
                                              ref.scores[i].numpy())


# --------------------------------------------------------------------------
# the port's own: every bucket against max_batch, fixed device planes
# --------------------------------------------------------------------------

CODECS = ("opq", "pq", "sq8", "refine:sq8:4", "flat")


@pytest.fixture(scope="module")
def codec_indexes(c):
    """One sparse (impact-plane) index per codec over one KMeans."""
    base = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size, device="cpu",
                    sparse=True, **dict(_KW, codec="opq"))
    out = {"opq": base}
    for codec in CODECS[1:]:
        out[codec] = hi.build(0, c.doc_emb, c.doc_tokens, c.vocab_size,
                              device="cpu", sparse=True,
                              cluster_sel=base.cluster_sel,
                              doc_assign=base.doc_assign,
                              **dict(_KW, codec=codec))
    return out


def _bucket_rows(rt, c, n):
    """n queries submitted together (the linger holds the batch) → the
    rows of one batch of bucket ≥ n."""
    futures = [rt.submit(c.query_emb[i], c.query_tokens[i])
               for i in range(n)]
    return [f.result(timeout=WAIT) for f in futures]


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("codec", CODECS)
def test_every_bucket_bit_identical_to_max_batch_rows(codec_indexes, c,
                                                      codec, fused):
    """A query's rows from a bucket of b equal its rows from
    ``Server.query``'s max_batch pad, for b = 1 .. max_batch: every
    query-side product runs at a fixed row count."""
    server = serve.make_server(codec_indexes[codec], serve.ServeConfig(
        max_batch=16, fusion_weight=0.5 if fused else None), device="cpu")
    direct = server.query(c.query_emb[:16], c.query_tokens[:16])
    with _runtime(server, c, linger_ms=100.0) as rt:
        for b in rt.buckets:
            for i, row in enumerate(_bucket_rows(rt, c, b)):
                _rows_equal(row, direct, i)
        assert rt.bucket_counts == {b: 1 for b in rt.buckets}


def test_mutable_device_planes_keep_their_addresses(built, c):
    """add_docs / delete_docs copy each epoch into the tensors of the
    first sync; compact() makes a new index with its own."""
    mut = _fresh_mut(built)
    mut.sync_device()
    delta, tomb = mut._device
    ptrs = [t.data_ptr() for t in seg._state_arrays(delta, tomb)
            if t is not None]
    ids = mut.add_docs(c.doc_emb[-8:], c.doc_tokens[-8:])
    mut.delete_docs(ids[:2])
    mut.sync_device()
    assert [t.data_ptr() for t in seg._state_arrays(*mut._device)
            if t is not None] == ptrs
    assert mut._device[1][ids[:2]].all()
    assert int(mut._device[0].cluster_lists.lengths.sum()) == 8


# --------------------------------------------------------------------------
# parity with the JAX package on a reference-built index
# --------------------------------------------------------------------------

@pytest.fixture(scope="module")
def jax_pair(c, tmp_path_factory):
    """(reference server, port server) over one JAX-built index saved with
    save_index and loaded into the port."""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint import checkpoint as jckpt
    from repro.core import hybrid_index as jhi
    from repro.launch import serve as jserve
    from repro_torch.checkpoint import checkpoint as ckpt

    idx = jhi.build(jax.random.key(0), jnp.asarray(c.doc_emb),
                    jnp.asarray(c.doc_tokens), c.vocab_size, **_KW)
    path = jckpt.save_index(str(tmp_path_factory.mktemp("rt")), 0, idx)
    widths = dict(kc=6, k2=8, top_r=100, max_batch=16)
    return (jserve.make_server(idx, jserve.ServeConfig(**widths)),
            serve.make_server(ckpt.load_index(path, device="cpu"),
                              serve.ServeConfig(**widths), device="cpu"))


def test_runtime_rows_match_the_reference_runtime(jax_pair, c):
    from repro.launch import runtime as jrt

    jserver, server = jax_pair
    jr = jrt.ServingRuntime(jserver, jrt.RuntimeConfig())
    jr.warmup(c.query_emb.shape[1], c.query_tokens.shape[1])
    with jr, _runtime(server, c) as rt:
        for lo, hi_ in ((0, 1), (1, 4), (4, 16)):
            want = jr.query(c.query_emb[lo:hi_], c.query_tokens[lo:hi_])
            got = rt.query(c.query_emb[lo:hi_], c.query_tokens[lo:hi_],
                           timeout=WAIT)
            np.testing.assert_array_equal(got.n_candidates,
                                          np.asarray(want.n_candidates))
            w_ids, w_s = np.asarray(want.doc_ids), np.asarray(want.scores)
            np.testing.assert_allclose(got.scores, w_s, rtol=TOL, atol=TOL)
            for b, p in zip(*np.nonzero(got.doc_ids != w_ids)):
                # a near-tie swap: the port's doc sits in the reference
                # list within TOL, or fell off its end within TOL
                where = np.flatnonzero(w_ids[b] == got.doc_ids[b, p])
                ref = w_s[b, where[0]] if where.size else w_s[b, -1]
                assert abs(ref - got.scores[b, p]) <= TOL + TOL * abs(ref)


def test_runtime_rows_equal_server_query_on_a_reference_index(jax_pair, c):
    _, server = jax_pair
    direct = server.query(c.query_emb[:16], c.query_tokens[:16])
    with _runtime(server, c, linger_ms=100.0) as rt:
        for b in rt.buckets:
            for i, row in enumerate(_bucket_rows(rt, c, b)):
                _rows_equal(row, direct, i)


def test_serve_cli_runs_the_runtime():
    src = inspect.getsource(serve.main)
    assert "--runtime" in src and "ServingRuntime" in src
    assert "not yet ported" not in src
