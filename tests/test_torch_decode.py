"""PyTorch port: ``serve.decode`` on the CPU — the block pool, token
streams, ``DecodeEngine`` and ``DecodeBatcher`` — held against the JAX
package where a number exists.

Ports of the ``TestBlockPool`` cases of ``tests/test_decode.py``
(``:70-185``): alloc/free, fragmentation, exhaustion, seat-based
admission; ``TokenStream``'s semantics; ``price_capacity`` against the
JAX function (with no budget the port's numbers are the reference's), a
priced capacity equal to the pool's admission limit and re-priced to the
same report; prefill bucket selection; no capture and no first bucket
run after ``warmup()`` across ragged prompt and generation lengths;
``refresh_params`` and ``reset_cache``; token-boundary join and leave
with occupancy, membership churn leaving tokens unchanged, queue
back-pressure, a QoS refusal, ``stop`` draining; greedy tokens equal to
``beam_search(K=1)``'s and to the JAX engine's on the same weights; a
prefill row equal to the JAX engine's; ``block_bytes`` against the JAX
function. The chaos, QoS router and TCP ``generate`` cases of
``tests/test_decode.py`` wait for ``fault/``, ``router.py`` and
``server.py``. The set-up is shared with ``tests/test_torch_nmt.py``
(``tests/test_torch_nmt_common.py``).
"""
import numpy as onp
import pytest
import torch

from incubator_mxnet_tpu import serve as jax_serve
from incubator_mxnet_tpu.serve.decode import blocks as jax_blocks
from incubator_mxnet_tpu_torch import serve
from incubator_mxnet_tpu_torch.base import MXNetError
from incubator_mxnet_tpu_torch.models import nmt
from incubator_mxnet_tpu_torch.serve.decode import (
    BlockPool, CacheExhausted, ShedError, TokenStream, block_bytes,
    blocks_per_sequence, price_capacity)

from test_torch_nmt_common import (  # noqa: F401  (fixtures)
    ENGINE, engine, engines, one_torch_thread, prompt, ref, table)


# ---------------------------------------------------------------------------
# Block pool (tests/test_decode.py:70-185)
# ---------------------------------------------------------------------------
class TestBlockPool:
    def test_alloc_append_free_roundtrip(self):
        pool = BlockPool(num_blocks=9, block_size=4, blocks_per_seq=4)
        table = pool.alloc_sequence("a")
        assert len(table) == 1 and pool.active_sequences() == 1
        pages = set(table)
        for i in range(4):
            page, slot, table = pool.append_token("a")
            assert slot == i
            pages.add(page)
        assert len(pages) == 1 and len(table) == 1
        page, slot, table = pool.append_token("a")  # boundary crossing
        assert slot == 0 and len(table) == 2 and page != table[0]
        assert pool.sequence_length("a") == 5
        pool.free_sequence("a")
        assert pool.active_sequences() == 0
        assert pool.free_blocks() == 8  # page 0 is the scratch page

    def test_fragmentation_reuse_after_free(self):
        pool = BlockPool(num_blocks=9, block_size=4, blocks_per_seq=4)
        pool.alloc_sequence("a")
        b_pages = set(pool.alloc_sequence("b"))
        for _ in range(5):
            _, _, t = pool.append_token("b")
        b_pages.update(t)
        assert len(b_pages) == 2
        free_before = pool.free_blocks()
        pool.free_sequence("b")
        assert pool.free_blocks() == free_before + len(b_pages)
        c_table = pool.alloc_sequence("c")
        for _ in range(5):
            _, _, c_table = pool.append_token("c")
        assert set(c_table) <= b_pages
        assert len(pool.sequence_table("a")) == 1

    def test_exhaustion_raises_and_recovers(self):
        pool = BlockPool(num_blocks=5, block_size=2, blocks_per_seq=2,
                         max_sequences=3)
        for sid in ("a", "b"):
            pool.alloc_sequence(sid)
            for _ in range(3):
                pool.append_token(sid)
            assert len(pool.sequence_table(sid)) == 2
        assert pool.free_blocks() == 0
        with pytest.raises(CacheExhausted):
            pool.alloc_sequence("c")
        assert pool.active_sequences() == 2
        pool.free_sequence("a")
        pool.alloc_sequence("c")
        assert pool.active_sequences() == 2
        for _ in range(4):
            pool.append_token("c")
        with pytest.raises(CacheExhausted):
            pool.append_token("c")  # would need page 3 of 2

    def test_admission_limit_caps_seats(self):
        pool = BlockPool(num_blocks=64, block_size=4, blocks_per_seq=4,
                         max_sequences=2)
        assert pool.admission_limit() == 2
        pool.alloc_sequence("a")
        assert pool.can_admit()
        pool.alloc_sequence("b")
        assert not pool.can_admit()
        with pytest.raises(CacheExhausted):
            pool.alloc_sequence("c")
        pool.free_sequence("a")
        assert pool.can_admit()
        assert pool.snapshot()["peak_blocks_in_use"] == 2

    def test_unknown_and_double_admission_raise(self):
        pool = BlockPool(num_blocks=5, block_size=4, blocks_per_seq=1)
        with pytest.raises(MXNetError):
            pool.append_token("ghost")
        pool.alloc_sequence("a")
        with pytest.raises(MXNetError, match="already admitted"):
            pool.alloc_sequence("a")
        with pytest.raises(MXNetError, match="scratch"):
            BlockPool(num_blocks=1, block_size=4, blocks_per_seq=1)


# ---------------------------------------------------------------------------
# TokenStream
# ---------------------------------------------------------------------------
class TestTokenStream:
    def test_stream_then_result(self):
        s = TokenStream()
        for t in (5, 7, 9):
            s.put_token(t)
        s.finish("eos")
        assert [s.next_token(timeout=1) for _ in range(3)] == [5, 7, 9]
        assert s.next_token(timeout=1) is None
        assert s.result(timeout=1) == [5, 7, 9]
        assert s.done() and s.finish_reason() == "eos"

    def test_next_token_timeout(self):
        s = TokenStream()
        with pytest.raises(TimeoutError):
            s.next_token(timeout=0.05)
        with pytest.raises(TimeoutError):
            s.result(timeout=0.05)

    def test_exception_propagates_to_both_reads(self):
        s = TokenStream()
        s.put_token(1)
        s.set_exception(serve.CacheExhausted("no pages"))
        with pytest.raises(serve.CacheExhausted):
            s.next_token(timeout=1)
        with pytest.raises(serve.CacheExhausted):
            s.result(timeout=1)
        assert s.done()


# ---------------------------------------------------------------------------
# Capacity pricing
# ---------------------------------------------------------------------------
class TestCapacity:
    @pytest.mark.parametrize("budget,fixed,per_block,T,bs,B", [
        (1 << 20, 1 << 18, 1 << 12, 64, 16, 64),
        (None, 0, 1024, 32, 8, 6),
        (1 << 10, 1 << 18, 1 << 12, 64, 16, 64),
        (10 ** 7, 3 * 10 ** 6, 777, 100, 16, 5),
    ])
    def test_price_capacity_matches_jax(self, budget, fixed, per_block, T,
                                        bs, B):
        kw = dict(hbm_budget=budget, fixed_bytes=fixed,
                  per_block_bytes=per_block, max_target_len=T,
                  block_size=bs, max_batch=B)
        cap = price_capacity(**kw)
        assert cap == jax_blocks.price_capacity(**kw)
        assert cap["blocks_per_seq"] == blocks_per_sequence(T, bs)
        assert cap["num_blocks"] == cap["max_sequences"] * \
            cap["blocks_per_seq"] + 1
        if budget is None:
            assert cap["max_sequences"] == B

    def test_no_budget_equals_the_reference(self, engine):
        """With no budget the engine prices what the JAX engine prices
        (``engine.py:228-263``): ``max_batch`` sequences and
        ``max_batch * blocks_per_seq + 1`` pages."""
        want = jax_blocks.price_capacity(
            hbm_budget=None, fixed_bytes=0, per_block_bytes=1,
            max_target_len=ENGINE["max_target_len"],
            block_size=ENGINE["block_size"], max_batch=ENGINE["max_batch"])
        assert engine.capacity == want
        assert engine.pool.admission_limit() == ENGINE["max_batch"]
        assert engine.pool.num_blocks == want["num_blocks"] == 9

    def test_priced_capacity_matches_pool_and_repricing(self, engine):
        """With a budget: the priced number is the pool's admission limit,
        and pricing again gives the same report; a budget too small for
        one sequence raises."""
        net = engine._model
        kw = dict(max_batch=4, block_size=4, max_target_len=16)
        probe = serve.DecodeEngine(net, table(), **kw, hbm_budget=1 << 30)
        fixed = probe.capacity["fixed_bytes"]
        per_seq = probe.capacity["per_block_bytes"] * 4
        engine = serve.DecodeEngine(net, table(), **kw,
                                    hbm_budget=fixed + 2 * per_seq + 1)
        cap = engine.capacity
        assert cap["max_sequences"] == engine.pool.admission_limit() == 2
        assert engine.capacity_report() == cap
        with pytest.raises(MXNetError, match="too small"):
            serve.DecodeEngine(net, table(), **kw, hbm_budget=fixed)


# ---------------------------------------------------------------------------
# Engine: prefill buckets and the warm contract
# ---------------------------------------------------------------------------
class TestEngineWarmContract:
    def test_prefill_bucket_selection(self, engine):
        assert [engine._table.bucket("src", n) for n in (2, 4, 5, 8)] \
            == [4, 4, 8, 8]
        with pytest.raises(serve.BucketOverflow):
            engine._table.bucket("src", 9)
        with pytest.raises(serve.BucketOverflow):
            serve.DecodeBatcher(engine).submit(onp.arange(9) + 3)

    def test_zero_captures_after_warmup_across_ragged_lengths(self,
                                                              engine):
        """Ragged prompt lengths ride the prefill buckets and generation
        length is no shape: after ``warmup()`` the decode step is never
        built again and no bucket runs for the first time."""
        rng = onp.random.RandomState(3)
        batcher = serve.DecodeBatcher(engine).start()
        try:
            streams = [batcher.submit(prompt(rng),
                                      max_new_tokens=int(rng.randint(1, 14)))
                       for _ in range(7)]
            lens = sorted({len(s.result(timeout=60)) for s in streams})
        finally:
            batcher.stop()
        assert len(lens) >= 2
        st = engine.stats()
        assert st["decode"] == {"compiles": 1, "warmup_compiles": 1,
                                "post_warmup_compiles": 0}
        assert st["prefill"]["post_warmup_compiles"] == 0
        assert st["prefill"]["warmup_compiles"] == 2
        assert st["warmed"] and st["decode_steps"] > 0
        assert st["capacity"]["max_sequences"] == 2
        assert st["pool"]["admission_limit"] == 2

    def test_engine_refresh_and_reset_cache(self, engine):
        """``refresh_params`` after an in-place weight update builds nothing
        again and the next step reads the new weights; ``reset_cache`` zeroes
        the pages."""
        net = engine._model
        before = dict(engine.decode_stats)
        pos = onp.zeros(ENGINE["max_batch"], "int32")
        tok = onp.full(ENGINE["max_batch"], 3, "int32")
        with torch.no_grad():
            net.proj_bias._var.add_(1.0)
        try:
            engine.refresh_params()
            assert engine.decode_stats == before
            bumped = engine.run_step(pos, tok)
        finally:
            with torch.no_grad():
                net.proj_bias._var.sub_(1.0)
        onp.testing.assert_allclose(bumped - engine.run_step(pos, tok), 1.0,
                                    atol=1e-5)
        engine.reset_cache()
        assert not engine._bufs["pool_k"].any()


# ---------------------------------------------------------------------------
# Continuous batching: join and leave at token boundaries
# ---------------------------------------------------------------------------
class TestContinuousBatching:
    def test_join_leave_ordering_and_occupancy(self, engines):
        engine = engines["engine"]
        rng = onp.random.RandomState(1)
        batcher = serve.DecodeBatcher(engine).start()
        try:
            streams = [batcher.submit(prompt(rng), max_new_tokens=n)
                       for n in (3, 9, 5, 7)]
            results = [s.result(timeout=60) for s in streams]
        finally:
            batcher.stop()
        for want, (got, s) in zip((3, 9, 5, 7), zip(results, streams)):
            assert 1 <= len(got) <= want
            assert s.finish_reason() in ("eos", "length")
        assert engine.pool.snapshot()["active_sequences"] == 0
        m = batcher.metrics.snapshot()
        assert m["requests"] == 4 and m["failed"] == 0 and m["shed"] == 0
        assert m["steps"] >= max(len(r) for r in results)
        assert 0.0 < m["step_occupancy"] <= 1.0
        assert m["tokens"] == sum(len(r) for r in results)

    def test_membership_churn_does_not_change_tokens(self, engines):
        engine = engines["engine"]
        rng = onp.random.RandomState(2)
        probe = prompt(rng, lo=5, hi=8)
        batcher = serve.DecodeBatcher(engine).start()
        try:
            alone = batcher.submit(probe, max_new_tokens=10).result(
                timeout=60)
            noise1 = batcher.submit(prompt(rng), max_new_tokens=12)
            churned = batcher.submit(probe, max_new_tokens=10)
            noise2 = batcher.submit(prompt(rng), max_new_tokens=4)
            assert churned.result(timeout=60) == alone
            noise1.result(timeout=60), noise2.result(timeout=60)
        finally:
            batcher.stop()

    def test_queue_backpressure_sheds_loudly(self, engines):
        batcher = serve.DecodeBatcher(engines["engine"], queue_limit=1)
        rng = onp.random.RandomState(4)
        batcher.submit(prompt(rng), max_new_tokens=2)
        with pytest.raises(serve.QueueFullError):
            batcher.submit(prompt(rng), max_new_tokens=2)
        assert batcher.metrics.snapshot()["shed"] == 1
        batcher.stop(drain=False)

    def test_qos_refusal_sheds_before_queueing(self, engines):
        class NoTokens:
            rate = 0

            def try_take(self, tenant, tokens):
                self.asked = (tenant, tokens)
                return False

        qos = NoTokens()
        batcher = serve.DecodeBatcher(engines["engine"], qos=qos)
        with pytest.raises(ShedError) as err:
            batcher.submit(onp.arange(3, 7), max_new_tokens=5, tenant="t")
        assert qos.asked == ("t", 5) and err.value.reason == "tenant_tokens"
        assert batcher.depth() == 0

    def test_stop_drains_and_fails_leftovers(self, engines):
        engine = engines["engine"]
        rng = onp.random.RandomState(5)
        batcher = serve.DecodeBatcher(engine).start()
        streams = [batcher.submit(prompt(rng), max_new_tokens=3)
                   for _ in range(3)]
        batcher.stop(drain=True)
        for s in streams:
            s.result(timeout=60)
        assert not batcher.worker_alive()
        with pytest.raises(MXNetError, match="stopped"):
            batcher.submit(prompt(rng))
        left = serve.DecodeBatcher(engine)
        s = left.submit(prompt(rng), max_new_tokens=3)
        left.stop(drain=False)
        with pytest.raises(MXNetError, match="batcher stopped"):
            s.result(timeout=1)


# ---------------------------------------------------------------------------
# Greedy tokens: the batcher, beam_search(K=1) and the JAX engine
# ---------------------------------------------------------------------------
def test_batcher_greedy_matches_beam_k1_and_the_jax_engine(engines):
    engine, jengine, net = engines["engine"], engines["jax"], engines["net"]
    rng = onp.random.RandomState(6)
    prompts = [prompt(rng, lo=5, hi=8) for _ in range(2)]
    batcher = serve.DecodeBatcher(engine).start()
    jbatcher = jax_serve.DecodeBatcher(jengine).start()
    try:
        got = [batcher.submit(p, max_new_tokens=10) for p in prompts]
        want = [jbatcher.submit(p, max_new_tokens=10) for p in prompts]
        got = [s.result(timeout=60) for s in got]
        want = [s.result(timeout=60) for s in want]
    finally:
        batcher.stop()
        jbatcher.stop()
    assert got == want
    for p, toks in zip(prompts, got):
        seqs, _ = nmt.beam_search(net, p[None], [float(len(p))],
                                  beam_size=1, max_length=11)
        ref = [int(t) for t in seqs[0, 0]]
        n = min(len(toks), len(ref))
        assert n and toks[:n] == ref[:n]


def test_prefill_row_matches_jax(engines):
    engine, jengine = engines["engine"], engines["jax"]
    prompt = onp.array([5, 3, 9, 4, 11], "int32")
    row, lp = engine.prefill_request(prompt)
    jrow, jlp = jengine.prefill_request(prompt)
    assert lp == jlp == 5 and row.shape == jrow.shape
    onp.testing.assert_allclose(row.numpy(), jrow, atol=1e-5)


def test_block_bytes_analytic():
    assert block_bytes(2, 16, 4) == 2 * 2 * 4 * 16 * 4
    assert block_bytes(2, 16, 4) == jax_blocks.block_bytes(2, 16, 4)
