"""The port's bench and eval tools (``nested_hashing_psi_tpu_torch/benchmarks``)
on the CPU, at small sizes, against the JAX package's tools where those
can run here.

- ``small_pie``: the PIE decrypts to the expected intersection, and its
  deterministic products (the packed table and masks, the client's cuckoo
  table) equal ``__graft_entry__._build_small_pie``'s for the same seeds
  (exact: integer residues).
- ``bench``: its JSON line carries the JAX bench's keys (``jnp_hbm`` as
  ``plain_hbm``, ``vmem_resident`` as ``l2_resident``, ``compile_s`` as
  ``first_call_s``), query 0's packed mask passes the check against the
  host decrypt, and a corrupted mask makes the check raise.
- ``profile_online`` prints its six and eight rows; ``bench_pie_online``
  (with its K2 check, which catches a difference), ``bench_ntt_kernel``,
  ``bench_ntt_f32mxu`` and ``scaling_report`` run (the sharded results
  bit-equal to the unsharded step); ``timing.chain`` feeds each output to
  the next call.
- ``summarize_eval`` prints exactly the JAX tool's lines on the committed
  ``eval_results/`` CSVs (the JAX script as a subprocess), writing nothing.
- ``run_eval`` writes the JAX package's CSV names and keys, with the same
  wire byte counts, for the same parameter row.
- ``comm_model``'s bytes equal the counts the parallel tests pin
  (``tests/test_torch_parallel.py``, ``tests/test_torch_ntt4.py``) and the
  counts measured on the card (PERF.md §5, `[parallel]`).
- Every tool that computes defaults to ``cuda`` and raises without a card.
"""

import contextlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu.config import HashTableParams as JHashTableParams
from nested_hashing_psi_tpu.config import PSIParams as JPSIParams
from nested_hashing_psi_tpu.protocol.runner import run_in_process as j_run_in_process
from nested_hashing_psi_tpu_torch.benchmarks import (
    bench,
    bench_ntt_anatomy,
    bench_ntt_f32mxu,
    bench_ntt_kernel,
    bench_ntt_lazy_probe,
    bench_pie_online,
    bench_vpu_ops,
    comm_model,
    profile_online,
    run_eval,
    scaling_report,
    small_pie,
    summarize_eval,
    timing,
)
from nested_hashing_psi_tpu_torch.fhe.device_decrypt import DeviceDecryptor
from nested_hashing_psi_tpu_torch.ops.ntt import NTTPlan, intt, ntt
from nested_hashing_psi_tpu_torch.ops.primes import ntt_primes

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
T32 = small_pie.T32
# a small bench row: ring 512, 2 x 64 slots, D = 2, P = 4
SMALL_ROW = dict(ring=512, simple=64, D=2, P=4)


def _u32(x) -> np.ndarray:
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x).view(np.uint32)


def test_small_pie_decrypts_to_the_intersection():
    built = small_pie.build_small_pie(ring=512, limbs=7, H=2, P=8, D=4, simple=64, t=T32,
                                      scheme="bfv", device="cpu")
    out = built.pie.run(built.idx_ct, built.minus_ct)
    assert out.data.shape[-2] == built.pie.ship_limbs < built.ctx.L
    slots, _ = built.ctx.decrypt(out, built.sk, length=built.pie.batch_slots)
    inter = built.ops.extract_intersection(slots)
    assert sorted(int(v) for v, _ in inter) == [105, 131]


@pytest.mark.parametrize("scheme,t,limbs", [("bfv", T32, 7), ("bgv", 65537, 6)])
def test_small_pie_tables_equal_the_jax_builders(scheme, t, limbs):
    """The hierarchical table's placement, the PIE's packed table and masks
    and the client's cuckoo table equal the JAX builder's (its keys and
    query noise come from another generator and are not compared)."""
    sys.path.insert(0, REPO)
    from __graft_entry__ import _build_small_pie

    kw = dict(ring=512, limbs=limbs, H=2, P=8, D=4, simple=64, t=t, scheme=scheme)
    _, _, _, jpie, jops, jidx, _ = _build_small_pie(**kw)
    built = small_pie.build_small_pie(**kw, device="cpu")
    np.testing.assert_array_equal(_u32(built.pie.table_pt), np.asarray(jpie.table_pt))
    np.testing.assert_array_equal(_u32(built.pie.mask_pt), np.asarray(jpie.mask_pt))
    np.testing.assert_array_equal(built.ops.client_table.table, jops.client_table.table)
    np.testing.assert_array_equal(built.ops.build_index_and_minus()[0],
                                  jops.build_index_and_minus()[0])
    assert tuple(built.idx_ct.data.shape) == tuple(jidx.data.shape)
    assert (built.pie.mul_limbs, built.pie.ship_limbs) == (jpie.mul_limbs, jpie.ship_limbs)


def test_small_pie_hierarchical_table_equals_the_jax_placement():
    """small_pie.tables against the JAX builder's table code
    (__graft_entry__.py:33-61) run on the JAX package's hashing classes."""
    from nested_hashing_psi_tpu.hashing import CuckooHashTable as JCuckoo
    from nested_hashing_psi_tpu.hashing import HierarchicalCuckooHashTable as JHCT
    from nested_hashing_psi_tpu.hashing import TabulationHashing as JTab
    from nested_hashing_psi_tpu.hashing.tabulation import items_from_ints as j_items

    H, P, D, simple, seed = 2, 8, 4, 64, 1
    hasher = JTab(987654321, 2 + H)
    jhct = JHCT(hasher, each_simple_table_size=simple, each_cuckoo_table_size=P,
                n_simple_hash_functions=2, n_cuckoo_hash_functions=H,
                max_items_per_position=D, seed=seed)
    jhct.insert_all(j_items(list(range(100, 100 + simple * 3))))
    jct = JCuckoo(hasher, each_table_size=simple, n_hash_functions=2,
                  max_items_per_position=1, seed=seed + 1)
    jct.insert_all(j_items(list(small_pie.CLIENT_ITEMS)))
    hct, ct = small_pie.tables(H, P, D, simple, seed)
    np.testing.assert_array_equal(hct.table, jhct.table)
    np.testing.assert_array_equal(ct.table, jct.table)
    assert (hct.table != 0).any(axis=-1).sum() == 2 * simple * 3  # every item, two simple slots


# the JAX bench's keys (bench.py:260-273), with the three renamed
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "resident", "hbm_batch", "pie_online"}
RENAMED = {"jnp_hbm": "plain_hbm", "vmem_resident": "l2_resident"}
JAX_PIE_KEYS = {"config", "H", "D", "P", "limbs", "batch_slots", "ms_per_query", "pipeline_Q",
                "ms_per_query_single", "ms_per_query_steady", "ms_per_query_device",
                "depth_rows_per_sec"}


def test_bench_json_has_every_key():
    rates = bench.ntt_rates(CPU, n=64, limbs=2, hbm_batch=2, l2_batch=1)
    pie = bench.pie_online(small_pie.bench_row(device="cpu", **SMALL_ROW), CPU, queries=2,
                           iters=1, steady_iters=1)
    res = bench.headline(rates, pie, CPU)
    assert bench.json.loads(bench.json.dumps(res)) == res
    assert JAX_KEYS | set(RENAMED.values()) <= set(res)
    assert not set(RENAMED) & set(res)
    assert JAX_PIE_KEYS | {"first_call_s"} <= set(res["pie_online"])
    assert "compile_s" not in res["pie_online"]
    assert res["pie_online"]["query0_mask_equals_host_decrypt"] is True
    assert res["device"] == "cpu" and res["vs_baseline"] is None  # no card, no share
    assert res["unit"] == "limb-transforms/s" and res["value"] > 0
    assert res["hbm_batch"] == 2 and res["pie_online"]["pipeline_Q"] == 2


def test_bench_query0_check_holds_and_catches_a_corrupted_mask():
    built = small_pie.bench_row(device="cpu", **SMALL_ROW)
    ctx, sk, pie = built.ctx, built.sk, built.pie
    out = pie.run(built.idx_ct, built.minus_ct)
    L_ship = out.data.shape[-2]
    dec = DeviceDecryptor(ctx.context_for_limbs(L_ship))
    zero = dec.zero_mask(out.data, ctx.shrink_key_to(sk, L_ship).s_mont)
    words = bench.pack_words(zero).numpy().astype(np.uint32)
    assert words.shape == (ctx.n // 32,)
    want = np.packbits(zero.any(dim=0).numpy().astype(np.uint8), bitorder="little")
    np.testing.assert_array_equal(words, want.view(np.uint32))
    slots, _ = ctx.decrypt(out, sk)
    bench.check_query0(words, slots)
    assert words.any()  # slots of the intersection decrypt to zero
    for flip in (0, ctx.n // 32 - 1):
        bad = words.copy()
        bad[flip] ^= np.uint32(1 << 5)
        with pytest.raises(RuntimeError, match="pipelined mask mismatch"):
            bench.check_query0(bad, slots)


@pytest.mark.parametrize("mode,rows", [("main", profile_online.MAIN_ROWS),
                                       ("hps", profile_online.HPS_ROWS)])
def test_profile_online_prints_its_rows(capsys, mode, rows):
    built = small_pie.bench_row(device="cpu", **SMALL_ROW)
    tag = "profile_online" if mode == "main" else "hps_parts"
    res = (profile_online.main_rows if mode == "main" else profile_online.hps_rows)(
        built, CPU, iters=1)
    profile_online.print_rows(tag, res)
    if mode == "main":
        profile_online.print_sum(res)
    out = capsys.readouterr().out
    assert tuple(res) == rows
    for name in rows:
        assert f"[{tag}] {name:>22}:" in out
    assert all(r["kernels"] is None and r["ms"] > 0 for r in res.values())  # no kernel on a CPU
    if mode == "main":
        assert "sum(parts)" in out


def test_profile_online_parts_compute_the_step():
    """The parts profile_online times compose to the step it profiles:
    hps_parts' chain gives main's hps_mul, and full_rescaled is the PIE's
    own result."""
    built = small_pie.bench_row(device="cpu", **SMALL_ROW)
    ctx, pie = built.ctx, built.pie
    a_d, b_d = profile_online._ip_operands(built)
    mc = ctx.mulconv
    ab = torch.stack([a_d, b_d])
    eab = ctx._ntt_fast_aux(mc.extend_q_to_aux(ctx._intt_fast(ab)))
    from nested_hashing_psi_tpu_torch.fhe.bgv import Ciphertext, tensor_product

    ta = mc.plan_aux.tensors(ctx.device)
    d_q = tensor_product(ab[0], ab[1], ctx.p, ctx.pinv, ctx.r2)
    d_aux = tensor_product(eab[0], eab[1], ta["p"], ta["pinv"], ta["r2"])
    y = mc.exact_to_q(mc.scale_round(ctx._intt_fast(d_q), ctx._intt_fast_aux(d_aux)))
    want = ctx._hps_mul_impl(Ciphertext(a_d, "bfv", 1), Ciphertext(b_d, "bfv", 1)).data
    assert torch.equal(ctx._ntt_fast(y), want)


def test_profile_online_trace_writes_its_directory(tmp_path):
    built = small_pie.bench_row(device="cpu", **SMALL_ROW)
    top = profile_online.capture_trace(built, CPU, str(tmp_path / "trace_online"), steps=1)
    assert top == [] and (tmp_path / "trace_online" / "trace.json").is_file()


@pytest.mark.parametrize("found,traces", [(2, 3), (None, 3), (0, 1)],
                         ids=["third_trace", "none_in_three", "first_trace"])
def test_traced_kernels_takes_an_empty_trace_again_on_the_card(monkeypatch, found, traces):
    """On the card a trace that recorded no kernel is taken again, up to
    TRACE_TRIES in all; an empty result is returned to the caller, which
    raises on it (profile_online)."""
    from nested_hashing_psi_tpu_torch.utils import profiling

    calls, read = [], []

    @contextlib.contextmanager
    def no_trace(d):
        yield

    def events(path):
        read.append(path)
        return [("k", 1.0)] if len(read) - 1 == found else []

    monkeypatch.setattr(timing, "_on_card", lambda device: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: None)
    monkeypatch.setattr(profiling, "device_trace", no_trace)
    monkeypatch.setattr(timing, "kernel_events", events)
    got = timing.traced_kernels(lambda: calls.append(1), "cuda", calls=2)
    assert got == ([] if found is None else [("k", 1.0)])
    assert timing.TRACE_TRIES == 3 and len(read) == traces and len(calls) == 1 + 2 * traces


def test_bench_pie_online_small_config_runs():
    res = bench_pie_online.run("small", CPU, ring=1024, iters=1)
    H, D, P, simple, n_simple, L = bench_pie_online.CONFIGS["small"]
    assert res["result_shape"] == [D, 2, L, 1024] and res["batch_slots"] == simple * n_simple
    assert res["table_bytes"] == H * D * P * L * 1024 * 4
    assert res["k2_share"] is None and res["k2_bound_by"] == "bytes"
    assert res["k2_max_abs_err"] == 0
    with pytest.raises(ValueError, match="do not fit ring"):
        bench_pie_online.run("2^20", CPU, ring=1024)


def test_bench_pie_online_k2_check_catches_a_difference(monkeypatch):
    """K2's check holds the whole position sum against the plain version in
    slices of depths: a residue off by one in the last slice raises before
    any time is taken."""
    monkeypatch.setattr(bench_pie_online, "K2_CHECK_DEPTHS", 4)
    pie, idx, _ = bench_pie_online.synthetic_pie("small", CPU, ring=1024)
    assert bench_pie_online.k2_max_abs_err(pie, idx) == 0
    real = bench_pie_online.position_sum

    def off_by_one(ctx, i, table):
        out = real(ctx, i, table).clone()
        out[-1, -1, -1, -1, -1] += 1
        return out

    monkeypatch.setattr(bench_pie_online, "position_sum", off_by_one)
    assert bench_pie_online.k2_max_abs_err(pie, idx) == 1
    with pytest.raises(RuntimeError, match="differs from its plain version"):
        bench_pie_online.run("small", CPU, ring=1024, iters=1)


def test_bench_ntt_kernel_chains_and_forms():
    ps = ntt_primes(2, 31, 2 * 256)
    plan = NTTPlan(256, ps)
    x = torch.from_numpy((np.random.default_rng(3).integers(0, min(ps), size=(3, 2, 256)))
                         .astype(np.int32))
    assert torch.equal(bench_ntt_kernel.run_chain(x, plan, False, "split", 2),
                       ntt(ntt(x, plan), plan))
    assert torch.equal(bench_ntt_kernel.run_chain(x, plan, True, "whole", 2),
                       intt(intt(x, plan), plan))
    res = [bench_ntt_kernel.rates(form, batch, CPU, n=256, limbs=2, iters=1)
           for form, batch in (("auto", 2), ("split", 3))]
    assert [(r["form"], r["batch"]) for r in res] == [("auto", 2), ("split", 3)]
    assert all(r["fwd_share"] is None and r["inv_limb_transforms_s"] > 0 for r in res)
    with pytest.raises(ValueError, match="form 'tiled'"):
        bench_ntt_kernel.main(["tiled:2", "--device", "cpu"])


def test_bench_ntt_f32mxu_runs_its_three_products():
    res = bench_ntt_f32mxu.run(CPU, m=16, tb=2, n=256, batch=1, iters=1)
    assert set(res["matmuls"]) == {"f32_digit_pair_stage", "f32_single_dense",
                                   "int8_stacked_stage"}
    assert res["allow_tf32"] is False and set(res["kernels"]) == {"k1", "k3"}


def test_scaling_report_ranks_are_bit_equal():
    rep = scaling_report.main(["--device", "cpu", "--ring", "64", "--limbs", "4", "--depths",
                               "4", "--positions", "4", "--iters", "1", "--ranks", "2"])
    assert [r["ranks"] for r in rep["rows"]] == [1, 1, 2]
    assert [r["transport"] for r in rep["rows"]] == ["none", "gloo", "gloo"]
    assert all(r["bit_equal"] for r in rep["rows"][1:])
    assert "not scale-out" in rep["note"]


def test_timing_chain_feeds_each_output_to_the_next_call():
    calls = []

    def double(x):
        calls.append(x.clone())
        return x * 2

    step = timing.chain(double, torch.ones(3))
    for k in range(1, 5):
        assert torch.equal(step(), torch.full((3,), 2.0 ** k))
    assert [int(c[0]) for c in calls] == [1, 2, 4, 8]


@pytest.mark.parametrize("clock", ["time_ms", "wall_ms", "graph_ms"])
def test_timing_on_the_cpu_calls_back_to_back(clock):
    """On the CPU every clock is the host's over the calls it was asked
    for after one warm-up, and returns a mean per call."""
    n = []
    ms = getattr(timing, clock)(lambda: n.append(1), CPU, 5)
    assert ms >= 0 and len(n) == 6


def test_summarize_eval_prints_the_jax_tools_lines(capsys):
    d = os.path.join(REPO, "eval_results")
    before = {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in os.listdir(d)}
    want = subprocess.run([sys.executable, os.path.join("benchmarks", "summarize_eval.py"),
                           "eval_results"], cwd=REPO, capture_output=True, text=True,
                          timeout=120, check=True).stdout
    summarize_eval.main([d])
    got = capsys.readouterr().out
    assert got == want and len(got.splitlines()) > 10
    assert {f: os.stat(os.path.join(d, f)).st_mtime_ns for f in os.listdir(d)} == before


def _csvs(d) -> dict:
    """file name -> [(key, value)] of each measurement CSV in d."""
    out = {}
    for name in sorted(os.listdir(d)):
        with open(os.path.join(d, name)) as f:
            out[name] = [tuple(line.strip().split(",")) for line in f if line.strip()]
    return out


def test_run_eval_writes_the_jax_exports_names_keys_and_bytes(tmp_path, monkeypatch):
    """One parameter row at tests/test_torch_protocol_e2e.py's small ring
    (128, 8 limbs), BatchedFHE with 16-bit items: the port's run_eval and the
    JAX package's run_in_process write the same files, keys and wire bytes.
    The JAX runner's loopback passes device arrays by reference and counts
    them as their payload plus 8 bytes, without the frame header a wire
    carries; here it serializes every frame, as TCP (and the port's loopback)
    does, so both count the bytes a wire would carry."""
    from nested_hashing_psi_tpu.protocol import runner as j_runner

    pair = j_runner.LoopbackChannel.pair
    monkeypatch.setattr(j_runner.LoopbackChannel, "pair",
                        classmethod(lambda cls, pass_device_arrays=False: pair(False)))
    row = dict(serverSetSize=300, clientSetSize=12, intersectionSetSize=5,
               eachSimpleTableSize=32, eachCuckooTableSize=12, nSimpleHF=2, maxPP=4)
    tsv = tmp_path / "rows.tsv"
    tsv.write_text("\t".join(row) + "\n" + "\t".join(str(v) for v in row.values()) + "\n")
    monkeypatch.setenv("NHPSI_RING_DIM", "128")
    monkeypatch.setenv("NHPSI_NUM_LIMBS", "8")
    done = run_eval.main(["--params", str(tsv), "--rows", "0:1", "--outdir",
                          str(tmp_path / "port"), "--device", "cpu"])
    assert [ok for _, ok in done] == [True]
    psi = JPSIParams(server_set_size=300, client_set_size=12, intersection_set_size=5,
                     bit_size=16, fhe=True, batched=True, ring_dim=128, num_limbs=8,
                     export_performance=True)
    ht = JHashTableParams(each_simple_table_size=32, each_cuckoo_table_size=12,
                          n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                          max_items_per_position=4)
    (tmp_path / "jax").mkdir()  # as the JAX run_eval makes its --outdir
    _, _, ok = j_run_in_process(psi, ht, export_dir=str(tmp_path / "jax"))
    assert ok
    port, jax_ = _csvs(tmp_path / "port"), _csvs(tmp_path / "jax")
    assert sorted(port) == sorted(jax_) and len(port) == 2
    for name in port:
        assert [k for k, _ in port[name]] == [k for k, _ in jax_[name]], name
        assert [kv for kv in port[name] if "Bytes" in kv[0]] == \
            [kv for kv in jax_[name] if "Bytes" in kv[0]], name
    assert any("Bytes" in k for rows in port.values() for k, _ in rows)


def test_run_eval_has_no_default_params():
    with pytest.raises(SystemExit):
        run_eval.parse_args([])
    assert run_eval.parse_args(["--params", "x"]).outdir.endswith("eval_results_torch")


# tests/test_torch_parallel.py's geometries: dp x tp (dp 4, tp 2, ring 64,
# L = 8) and the pipelined step over 8 ranks; the ring exchange of
# tests/test_torch_ntt4.py
def test_comm_model_bytes_equal_the_pinned_counts():
    H, D, L, N = 2, 8, 8, 64
    assert comm_model.dp_tp_bytes(H, D, L, N, 4, 2) == \
        (H * (D // 4) * 2 + 2) * (L // 2) * N * 4 * (2 - 1)
    assert comm_model.pp_bytes(H, D, L, N, 8) == (8 - 1) * H * (D // 8) * 2 * L * N * 4
    for S in (4, 8):  # one limb transform of one row: log2(D) (n/D) L batch 4
        assert comm_model.sp_bytes(1, 256, S) == (S.bit_length() - 1) * (256 // S) * 4


def test_comm_model_bytes_equal_the_cards_counts():
    """The counts the sharded steps' ranks measured on the card (PERF.md):
    2^20 row, ring 16384, BFV L = 6 (9 aux primes) and flat BGV L = 9."""
    KA = comm_model.aux_limbs(6)
    assert KA == 9
    assert comm_model.sp_transforms(2, 12, 6, "bfv", KA) == 1980
    assert comm_model.sp_bytes(1980, 16384, 4) == 64_880_640
    assert comm_model.sp_bytes(comm_model.sp_transforms(2, 12, 9, "bgv"), 16384, 4) == \
        35_389_440
    assert comm_model.dp_tp_bytes(2, 12, 6, 16384, 2, 2) == 5_111_808
    assert comm_model.pp_bytes(2, 12, 6, 16384, 4) == 14_155_776


def test_comm_model_needs_a_link_rate(capsys):
    with pytest.raises(SystemExit):
        comm_model.main([])
    out = comm_model.main(["--link-GBps", "100", "--t1-ms", "15"])
    row = out[0]
    assert row["L"] == 6 and row["sp_transforms_per_query"] == 1980
    by = {r["strategy"]: r for r in row["rows"]}
    assert by["dp2 x tp2"]["bytes_per_rank_per_query"] == 5_111_808
    assert "does_not_split" in by["pp8"] and "modeled_ms" in by["sp8"]


@pytest.mark.parametrize("tool,argv", [
    (bench.main, []), (profile_online.main, []), (bench_pie_online.main, []),
    (bench_ntt_kernel.main, []), (bench_ntt_f32mxu.main, []), (scaling_report.main, []),
])
def test_tools_default_to_cuda_and_raise_without_a_card(monkeypatch, tool, argv):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tool(argv)


@pytest.mark.parametrize("probe", [bench_vpu_ops, bench_ntt_lazy_probe, bench_ntt_anatomy],
                         ids=["vpu_ops", "lazy", "anatomy"])
def test_probes_refuse_devices_other_than_cpu_and_cuda(probe):
    with pytest.raises(ValueError, match="cpu or cuda only"):
        probe.main(["--device", "meta"])


def test_run_eval_defaults_to_cuda_and_raises_without_a_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tsv = tmp_path / "rows.tsv"
    tsv.write_text("serverSetSize\tclientSetSize\tintersectionSetSize\teachSimpleTableSize\t"
                   "eachCuckooTableSize\tnSimpleHF\tmaxPP\n300\t12\t5\t32\t12\t2\t4\n")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        run_eval.main(["--params", str(tsv), "--outdir", str(tmp_path / "out")])
