"""The port's root benchmark scripts (`hcrag_tpu_torch/benchmarks/`) against
the JAX package's (`benchmarks/`), on the CPU at small sizes.

Each case feeds the same numpy-seeded inputs to what a timed variant of
the port's script computes and to what the JAX script's variant computes
(its functions, with the Pallas kernels in interpret mode; a variant the
JAX script defines inside its `main` is restated here in JAX).  Indices
exact, f32 values within 1e-5 unless a case says otherwise.  The JAX
scripts that run whole here (`reranker_eval`, `sharded_10m`) have their
module constants pointed into `tmp_path`, so nothing is written under
`benchmarks/`."""

import functools
import json

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from hcrag_tpu_torch.benchmarks import (
    ablation,
    dispatch_floor,
    expansion_heavy,
    hbm_bandwidth,
    merge_micro,
    reranker_eval,
    scoring_ablation,
    sharded_10m,
    sharded_traffic,
    twolevel_ablation,
)

jnp = jax.numpy
CPU = torch.device("cpu")


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _same_topk(got, want, atol=1e-5):
    (gv, gi), (wv, wi) = got, want
    np.testing.assert_array_equal(_np(gi), np.asarray(wi))
    np.testing.assert_allclose(_np(gv), np.asarray(wv), atol=atol, rtol=0)


# ---------------------------------------------------------------------------
# hbm_bandwidth
# ---------------------------------------------------------------------------
def test_hbm_variants_equal_jax():
    bf16, int8 = hbm_bandwidth.banks(CPU, n=4000, d=128)
    rng = np.random.default_rng(7)
    e = rng.standard_normal((4096, 128)).astype(np.float32)  # padded to whole tiles
    d_bf16 = jnp.asarray(e.astype(ml_dtypes.bfloat16))
    d_int8 = jnp.asarray((e * 16).clip(-127, 127).astype(np.int8))
    np.testing.assert_array_equal(bf16.view(torch.int16).numpy(),
                                  np.asarray(d_bf16).view(np.int16))
    np.testing.assert_array_equal(int8.numpy(), np.asarray(d_int8))
    calls = hbm_bandwidth.variants(bf16, int8)
    assert list(calls) == ["xla_reduce_bf16_1MiB", "xla_reduce_int8_0MiB",
                           "folded_reduce_bf16_16x", "folded_reduce_int8_16x",
                           "xla_copy_bf16_rw"]
    want_bf16 = float(jnp.sum(d_bf16, dtype=jnp.float32))
    # The int8 rows read the same bank as 32-bit words (a memory-bound read).
    want_int8 = int(np.asarray(d_int8).view(np.int32).max())
    for key, fn in calls.items():
        got = fn()
        if "copy" in key:
            want = d_bf16 * jnp.asarray(1.0009765625, d_bf16.dtype)
            np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                          np.asarray(want).view(np.int16))
        elif "int8" in key:
            assert got.dtype == torch.int32 and int(got) == want_int8
        else:
            assert abs(float(got) - want_bf16) <= 1e-5 * np.abs(e).sum()


def test_hbm_run_reports_every_key():
    res = hbm_bandwidth.run("cpu", n=4096, d=128, steps=1)
    rows = [k for k in res["share_of_assumed_peak"]]
    assert len(rows) == 5 and all(res[k] > 0 for k in rows)
    assert res["assumed_peak_gib_s"] == pytest.approx(3.35e12 / 2**30)


# ---------------------------------------------------------------------------
# dispatch_floor
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("a,d", [(0.0, 1e-5), (5.7, 2.5e-6), (0.04, 3.1e-8)])
def test_dispatch_fit_is_exact_on_synthetic_times(a, d):
    ns = dispatch_floor.SIZES
    ts = [a + d * n for n in ns]
    got_a, got_d = dispatch_floor.fit_line(ns, ts)
    want_d, want_a = np.polyfit(np.asarray(ns, np.float64), np.asarray(ts, np.float64), 1)
    assert got_a == float(want_a) and got_d == float(want_d)
    assert got_a == pytest.approx(a, abs=1e-9) and got_d == pytest.approx(d, rel=1e-9)


def test_dispatch_select_equals_jax():
    import hcrag_tpu.ops.topk_pallas as tp

    rng = np.random.default_rng(7)
    q = rng.standard_normal((8, 128)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e = rng.standard_normal((8192, 128)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    eb = torch.from_numpy(e).to(torch.bfloat16)
    got = dispatch_floor.select(torch.from_numpy(q), eb, torch.ones(8192, dtype=torch.bool))
    want = tp.pallas_cosine_top_k(
        jnp.asarray(q), jnp.asarray(e.astype(ml_dtypes.bfloat16)), jnp.ones(8192, bool),
        top_k=10, tile_n=2048, packed_select=True, merge_k=32, two_level=True,
        interpret=True)
    _same_topk(got, want)


def test_dispatch_run_fits_both_clocks():
    res = dispatch_floor.run("cpu", sizes=(2048, 4096), d=64, b=4, steps=1)
    assert set(res["per_call_ms"]) == {"2048", "4096"}
    for key in ("fit_dispatch_overhead_ms", "fit_device_ms_per_1M_rows",
                "implied_min_read_gib_s_if_dma_bound", "fit_event_overhead_ms",
                "fit_event_ms_per_1M_rows"):
        assert np.isfinite(res[key])


# ---------------------------------------------------------------------------
# merge_micro
# ---------------------------------------------------------------------------
def _jax_merge_variants():
    """The JAX script's variants (defined inside its main), and its
    docstring's packed_pallas: the production `_packed_candidate_merge`."""
    import hcrag_tpu.ops.topk_pallas as tp

    m = merge_micro.M

    def xla_topk(v, i):
        ov, pos = jax.lax.top_k(v, m)
        return ov, jnp.take_along_axis(i, pos, axis=1)

    def argmax32(v, i):
        col = jax.lax.broadcasted_iota(jnp.int32, v.shape, 1)
        outs_v, outs_p = [], []
        for _ in range(m):
            best = jnp.max(v, axis=1)
            first = jnp.argmax(v == best[:, None], axis=1)
            outs_v.append(best)
            outs_p.append(first)
            v = jnp.where(col == first[:, None], -jnp.inf, v)
        pos = jnp.stack(outs_p, axis=1)
        return jnp.stack(outs_v, axis=1), jnp.take_along_axis(i, pos, axis=1)

    return {"xla_topk_ms": xla_topk, "argmax32_ms": argmax32,
            "packed_pallas_ms": lambda v, i: tp._packed_candidate_merge(v, i, m, True)}


def test_merge_variants_equal_jax():
    """The JAX script's pool at 128 of its 512 queries: torch.topk and
    argmax32 equal `lax.top_k` (values and index sets); kernel B2 equals
    JAX's packed merge bit for bit, and its index sets `lax.top_k`'s."""
    v, i = merge_micro.pool(CPU, b=128)
    jv, ji = jnp.asarray(v.numpy()), jnp.asarray(i.numpy())
    jax_calls = _jax_merge_variants()
    want_v, want_i = jax_calls["xla_topk_ms"](jv, ji)
    want_sets = np.sort(np.asarray(want_i), axis=1)
    for key, fn in merge_micro.variants(v, i).items():
        gv, gi = fn()
        np.testing.assert_array_equal(np.sort(_np(gi), axis=1), want_sets, err_msg=key)
        if key == "packed_pallas_ms":
            _same_topk((gv, gi), jax_calls[key](jv, ji), atol=0)
        else:
            np.testing.assert_array_equal(_np(gv), np.asarray(want_v), err_msg=key)
            _same_topk((gv, gi), jax_calls[key](jv, ji), atol=0)


def test_merge_run_keys():
    res = merge_micro.run("cpu", b=8, c=4890)
    assert {"xla_topk_ms", "argmax32_ms", "packed_pallas_ms"} <= set(res)
    assert "approx_max_k_ms" not in res


# ---------------------------------------------------------------------------
# scoring_ablation
# ---------------------------------------------------------------------------
def _jax_scoring_routes(x):
    from hcrag_tpu.ops.scoring import node_type_priority_scores, semantic_similarity_scores
    from hcrag_tpu.ops.scoring_pallas import pallas_batch_relevance

    d = {k: jnp.asarray(v) for k, v in x.items()}
    w = jnp.asarray(np.array(scoring_ablation.WEIGHTS, np.float32))
    args = (d["q_emb"], d["q_bits"], d["q_counts"], d["intents"], d["n_emb"], d["n_bits"],
            d["n_counts"], d["n_types"])

    def jnp_path(q_emb, q_bits, q_counts, intents, n_emb, n_bits, n_counts, n_types, w):
        sem = semantic_similarity_scores(q_emb, n_emb)
        inter = jnp.sum(jax.lax.population_count(q_bits[:, None, :] & n_bits[None, :, :]),
                        axis=-1)
        ratio = inter.astype(jnp.float32) / jnp.maximum(
            q_counts[:, None].astype(jnp.float32), 1.0)
        ent = jnp.where((q_counts == 0)[:, None],
                        jnp.where((n_counts == 0)[None, :], 0.5, 0.1), ratio)
        typ = node_type_priority_scores(intents, n_types)
        metrics = jnp.stack([sem, jnp.zeros_like(sem), ent, typ], axis=-1)
        return jnp.einsum("bnm,m->bn", metrics, w)

    return {"jnp_ms": jax.jit(jnp_path)(*args, w),
            "pallas_ms": pallas_batch_relevance(*args, w, interpret=True)}


def test_scoring_routes_equal_jax():
    """The JAX script's draws at its B=256 for its first two banks (128 and
    1,024 nodes): both routes within 1e-5 of JAX's."""
    rng = np.random.default_rng(3)
    for n_nodes in scoring_ablation.NODES[:2]:
        x = scoring_ablation.draw(rng, n_nodes)
        want = _jax_scoring_routes(x)
        for key, fn in scoring_ablation.variants(x, CPU).items():
            got = fn()
            assert got.shape == (scoring_ablation.B, n_nodes)
            np.testing.assert_allclose(got.numpy(), np.asarray(want[key]), atol=1e-5,
                                       rtol=0, err_msg=f"{key} N={n_nodes}")


def test_scoring_run_keys():
    res = scoring_ablation.run("cpu", nodes=(128,), b=4, d=64, steps=1)
    assert set(res["n128"]) == {"jnp_ms", "pallas_ms", "pallas_speedup"}
    assert res["config"] == {"batch": 4, "dim": 64, "bitset_words": 8}


# ---------------------------------------------------------------------------
# twolevel_ablation
# ---------------------------------------------------------------------------
def test_twolevel_rows_equal_jax():
    """8,192 rows of 384, 16 queries: each row's call against the JAX
    kernel call it stands for (interpret mode), and the recall key against
    the JAX script's computation over the same calls."""
    import hcrag_tpu.ops.topk_pallas as tp
    from hcrag_tpu.ops.quantize import quantize_rows

    x = twolevel_ablation.banks(CPU, n=8192, d=384, b=16)
    rng = np.random.default_rng(7)
    e = rng.standard_normal((8192, 384)).astype(np.float32)
    e /= np.linalg.norm(e, axis=1, keepdims=True)
    q = rng.standard_normal((16, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    e8, sc = quantize_rows(e)
    np.testing.assert_array_equal(x["e8"].numpy(), e8)
    np.testing.assert_array_equal(x["sc"].numpy(), sc)
    dq, dm = jnp.asarray(q), jnp.ones(8192, bool)
    d8, dsc = jnp.asarray(e8), jnp.asarray(sc)
    db = jnp.asarray(e.astype(ml_dtypes.bfloat16))
    jax_rows = {
        "int8_packed_two_level": functools.partial(
            tp.pallas_cosine_top_k_int8, dq, d8, dsc, dm, 10, packed_select=True, merge_k=32,
            two_level=True),
        "bf16_exact_kpass": functools.partial(tp.pallas_cosine_top_k, dq, db, dm, 10,
                                              merge_k=32),
        "bf16_packed_two_level": functools.partial(tp.pallas_cosine_top_k, dq, db, dm, 10,
                                                   packed_select=True, merge_k=32),
        "int8_exact": functools.partial(tp.pallas_cosine_top_k_int8, dq, d8, dsc, dm, 10,
                                        packed_select=False, merge_k=32),
    }
    for key, fn in twolevel_ablation.variants(x).items():
        want = jax_rows[key](interpret=True)
        _same_topk(fn(), want)
        if key == "int8_packed_two_level":
            i = np.asarray(want[1])[:8]
            ref = np.argsort(-(q[:8] @ e.T), axis=1, kind="stable")[:, :10]
            jax_recall = np.mean([len(set(i[b]) & set(ref[b])) / 10 for b in range(8)])
    assert twolevel_ablation.top10_in_merge32(x) == jax_recall


def test_twolevel_run_prints_the_kpass_key_as_the_two_level_one():
    res = twolevel_ablation.run("cpu", n=4096, d=64, b=8, steps=1)
    assert res["int8_packed_kpass"] == res["int8_packed_two_level"]
    assert set(res["ms"]) == {"int8_packed_two_level", "bf16_exact_kpass",
                              "bf16_packed_two_level", "int8_exact"}
    assert 0.0 <= res["int8_two_level_top10_in_merge32_vs_f32_brute"] <= 1.0


# ---------------------------------------------------------------------------
# ablation
# ---------------------------------------------------------------------------
def _same_step(got, want, where):
    """The 7 outputs of the query step: indices, counts and expansion
    exact; scores within 1e-5."""
    for j, (g, w) in enumerate(zip(got, want)):
        g, w = _np(g), np.asarray(w)
        if g.dtype.kind in "iu" or w.dtype.kind in "iu":
            np.testing.assert_array_equal(g, w, err_msg=f"{where}[{j}]")
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0, err_msg=f"{where}[{j}]")


def test_ablation_stages_equal_jax():
    """20,000 rows (the CPU size), 16 queries: every stage against the JAX
    script's over the same bf16 rows; the streaming selection (the 1M
    path's stage 2) against JAX's too."""
    from __graft_entry__ import _synthetic_setup
    from hcrag_tpu.ops.similarity import masked_top_k as jax_masked_top_k
    from hcrag_tpu.ops.similarity import streaming_masked_top_k as jax_streaming
    from hcrag_tpu.ops.topk_pallas import pallas_cosine_top_k
    from hcrag_tpu.query.engine import QueryEngine as JaxEngine
    from hcrag_tpu_torch.ops.similarity import streaming_masked_top_k

    n, b, k = 20_000, 16, 10
    x = ablation.setup(CPU, n, b)
    index, graph = _synthetic_setup(n, 384, graph_degree=4)
    emb_bf16 = np.asarray(index.emb, np.float32).astype(ml_dtypes.bfloat16)
    index.emb = emb_bf16
    dE = jnp.asarray(emb_bf16)
    q = np.random.default_rng(7).standard_normal((b, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    dq, mask = jnp.asarray(q), jnp.ones((n,), bool)
    n_pad = -(-n // 2048) * 2048
    engine = JaxEngine(index, graph, ell_max_degree=8, use_pallas=True, pallas_interpret=True)
    jdots = jnp.dot(dq.astype(dE.dtype), dE.T, preferred_element_type=jnp.float32)
    want = {
        ablation.DOTS: jdots.sum(axis=1),
        ablation.DOTS_F64: jdots.sum(axis=1),
        "matmul + chunked XLA top-k": jax_masked_top_k(jdots, mask, k),
        ablation.FUSED: pallas_cosine_top_k(
            dq, jnp.asarray(np.pad(emb_bf16, ((0, n_pad - n), (0, 0)))),
            jnp.asarray(np.arange(n_pad) < n), k, tile_n=2048, interpret=True),
        ablation.STEP_D1: engine.query_batch_device(dq, top_k=k, expansion_depth=1,
                                                    max_expanded=20),
        ablation.STEP_MAX1: engine.query_batch_device(dq, top_k=k, expansion_depth=1,
                                                      max_expanded=1),
    }
    calls = ablation.variants(x, k)
    assert list(calls) == list(want)
    for label, fn in calls.items():
        got = fn()
        if label in (ablation.DOTS, ablation.DOTS_F64):
            scale = np.abs(np.asarray(jdots)).sum(axis=1)
            assert np.all(np.abs(got.numpy() - np.asarray(want[label])) <= 1e-5 * scale)
        elif label.startswith("full step"):
            _same_step(got, want[label], label)
        else:
            _same_topk(got, want[label])
    _same_topk(streaming_masked_top_k(x["q"], x["e"], x["mask"], k),
               jax_streaming(dq, dE, mask, k, chunk_rows=1 << 13))


def test_ablation_labels_follow_the_size():
    assert ablation.select_label(1_000_000) == "matmul + streaming XLA top-k"
    assert ablation.select_label(1 << 18) == "matmul + chunked XLA top-k"


# ---------------------------------------------------------------------------
# expansion_heavy
# ---------------------------------------------------------------------------
def test_expansion_stages_equal_jax():
    """4,096 rows, degree 8, 4 queries: the stages against the JAX script's
    calls.  JAX's engine compiles its interpreted B5 at k = 100 once, for
    the depth-3 step: the retrieval is that step's selection and rescore
    (its first two outputs), and the depth-1 step equals the depth-3 one
    whole, since 100 seeds of degree 8 pass the 20-node cap at the first
    hop and the early exit stops there."""
    from __graft_entry__ import _synthetic_setup
    from hcrag_tpu.ops.expand import _ordered_unique_mask, expand_batch
    from hcrag_tpu.query.engine import QueryEngine as JaxEngine

    n, b = 4096, 4
    x = expansion_heavy.setup(CPU, n, b)
    index, graph = _synthetic_setup(n, 384, graph_degree=8)
    engine = JaxEngine(index, graph, ell_max_degree=8, exact_rescore=32, use_pallas=True,
                       pallas_interpret=True)
    rng = np.random.default_rng(7)
    q = rng.standard_normal((b, 384)).astype(np.float32)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    seeds = jnp.asarray(rng.integers(0, n, size=(b, 100)).astype(np.int32))
    cand = jnp.asarray(rng.integers(-1, n, size=(b, x["cand"].shape[1])).astype(np.int32))
    step = engine.query_batch_device(jnp.asarray(q), top_k=100, expansion_depth=3)
    want = {
        "full_step": step,
        "retrieval_only": step[:2],
        "expansion_only": expand_batch(engine.d_neighbors, seeds, depth=3, max_nodes=20,
                                       hop2_neighbors=engine.d_neighbors_hop2),
        "dedup_only": jax.vmap(lambda c: _ordered_unique_mask(c, n))(cand),
        "full_step_depth1": step,
    }
    for key, fn in expansion_heavy.variants(x).items():
        got = fn()
        if key == "dedup_only":
            np.testing.assert_array_equal(got.numpy(), np.asarray(want[key]))
        else:
            _same_step(got, want[key], key)


def test_expansion_run_keys():
    res = expansion_heavy.run("cpu", n=4096, b=4, steps=1)
    assert res["shapes"]["b"] == 4 and res["shapes"]["dedup_width"] == 58_400
    for key in ("full_step_qps", "retrieval_only_qps", "expansion_only_ms_per_batch",
                "dedup_only_ms_per_batch", "full_step_depth1_qps"):
        assert res[key] > 0


# ---------------------------------------------------------------------------
# reranker_eval
# ---------------------------------------------------------------------------
def test_reranker_eval_equals_jax(tmp_path, monkeypatch):
    """The seeded corpus and its pickle in tmp_path, the JAX script's main
    over them (its constants redirected; it merges its entry into an empty
    results file there) and the port's `run` on the CPU: the orders that
    need no training within 1e-6, the re-ranked ones within 0.02 (AdamW
    turns the rounding of zero-gradient biases into steps, ROADMAP §C)."""
    import benchmarks.reranker_eval as jax_eval

    data, pickle = reranker_eval.seeded_corpus(str(tmp_path))
    results = tmp_path / "results.json"
    results.write_text("{}")
    monkeypatch.setattr(jax_eval, "DATA_DIR", data)
    monkeypatch.setattr(jax_eval, "PICKLE", pickle)
    monkeypatch.setattr(jax_eval, "RESULTS", results)
    jax_eval.main()
    want = json.loads(results.read_text())["reranker_judge_distill"]
    got = reranker_eval.run("cpu", data, pickle)
    assert set(want) <= set(got)
    for key in ("train_queries", "test_queries", "candidates_per_query", "teacher"):
        assert got[key] == want[key]
    for key in ("ndcg10_cosine_order", "ndcg10_baseline_combined", "top1_agreement_baseline"):
        assert got[key] == pytest.approx(want[key], abs=1e-4 + 1e-6)  # JAX rounds to 4 places
    for key in ("ndcg10_reranked", "top1_agreement_reranked"):
        assert got[key] == pytest.approx(want[key], abs=0.02)
    assert got["lift"] == pytest.approx(got["ndcg10_reranked"] - got["ndcg10_baseline"])


def test_reranker_eval_refuses_half_a_source():
    with pytest.raises(ValueError, match="--pickle"):
        reranker_eval.run("cpu", data="somewhere")
    with pytest.raises(ValueError, match="--data"):
        reranker_eval.run("cpu", pickle="somewhere.pkl")


# ---------------------------------------------------------------------------
# sharded_traffic
# ---------------------------------------------------------------------------
def test_sharded_traffic_equals_jax_hlo_and_model():
    """2 and 4 gloo ranks (one spawn) against the JAX script's count in the
    compiled HLO on 2 and 4 of the conftest's virtual devices."""
    import benchmarks.sharded_traffic as jax_traffic

    got = sharded_traffic.run("cpu", shards=(2, 4))
    assert got["summary"]["matches_model"] and got["summary"]["top10_equals_f32_brute"]
    assert got["summary"]["rescore_traffic_constant_in_shards"]
    assert got["summary"]["merge_traffic_scales_linearly_in_shards"]
    for s in (2, 4):
        colls = jax_traffic.collective_bytes(jax_traffic.lower_sharded_step(s))
        row = got[f"shards_{s}"]
        assert row["all_gather_bytes"] == sum(c[3] for c in colls if c[0] == "all-gather")
        assert row["all_reduce_bytes"] == sum(c[3] for c in colls if c[0] == "all-reduce")
        assert row["all_gather_bytes"] == s * 8 * 32 * 8
        assert row["all_reduce_bytes"] == 8 * 32 * 4


# ---------------------------------------------------------------------------
# sharded_10m
# ---------------------------------------------------------------------------
def test_sharded_10m_equals_jax(tmp_path, monkeypatch, capsys):
    """20,000 rows with the degree-8 graph: the port on 2 gloo ranks, the
    JAX script on a 2-device virtual mesh, both modes: the same top
    indices, recall and per-rank memory (JAX prints it to 3 places)."""
    import benchmarks.sharded_10m as jax_10m
    import hcrag_tpu.parallel.mesh as jax_mesh
    from hcrag_tpu.parallel.sharded_engine import ShardedQueryEngine

    got = sharded_10m.run("cpu", n=20_000, ranks=2, modes=("bf16_rescore", "int8_residual"))
    real_mesh, real_query = jax_mesh.make_row_mesh, ShardedQueryEngine.query_batch
    seen = []

    def recording(self, *a, **kw):
        res = real_query(self, *a, **kw)
        seen.append((np.asarray(res.top_indices), self._n_padded))
        return res

    monkeypatch.setattr(jax_mesh, "make_row_mesh", lambda n=None: real_mesh(2))
    monkeypatch.setattr(ShardedQueryEngine, "query_batch", recording)
    monkeypatch.setattr(jax_10m, "RESULTS", tmp_path / "results.json")
    monkeypatch.setenv("BENCH10M_N", "20000")
    for mode in ("bf16_rescore", "int8_residual"):
        monkeypatch.setenv("BENCH10M_MODE", mode)
        capsys.readouterr()
        jax_10m.main()
        want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        entry = got[mode]
        top, jax_pad = seen[-1]
        np.testing.assert_array_equal(np.asarray(entry["top_indices"]), top)
        assert entry["recall_at_10"] == want["recall_at_10"]
        # The port pads each rank's block to whole 2048-row tiles, as the
        # JAX engine does on the TPU; JAX's int8 route on the CPU pads none.
        _, sel, extra, _ = sharded_10m.MODES[mode]
        pad_gb = (entry["n_padded"] - jax_pad) * (384 * (sel + extra) / 2 + 28) / 2**30
        assert round(entry["per_chip_gb"] - pad_gb, 3) == want["per_chip_gb"]
        assert (entry["mode"], entry["n"]) == (want["mode"], want["n"])
        assert entry["self_retrieval_exact"] and entry["mesh_devices"] == 2
    assert not (tmp_path / "results.json").exists()
