"""The trace arithmetic and the per-layer readers, on a made-up trace."""

import pytest

from psi_bench import run, spec, trace
from psi_bench.tests.tiny import REPO


def test_union_and_gaps():
    iv = [(0, 5), (3, 8), (10, 12), (11, 11)]
    assert trace.union_ns(iv, 0, 20) == 10
    assert trace.union_ns(iv, 4, 11) == 5
    assert trace.gaps_ns(iv, 0, 20) == [(8, 10), (12, 20)]
    assert trace.gaps_ns([], 3, 7) == [(3, 7)]


def test_k2_bound_is_bytes_at_the_main_path_shape():
    nbytes = 4 * (2 * 12 * 2 * 6 * 16384 + 2 * 12 * 12 * 6 * 16384 + 2 * 12 * 2 * 6 * 16384) + 48
    assert trace.k2_bound_s(2, 12, 12, 6, 16384) == pytest.approx(nbytes / 3.35e12)
    assert trace.k2_bound_s(2, 12, 12, 6, 16384) * 1e3 == pytest.approx(0.0451, abs=1e-4)


def made_up_run():
    ms = 1_000_000
    ops = [
        ("copy", "Memcpy HtoD", 1 * ms, 2 * ms),
        ("kernel", "pie_ip_kernel", 2 * ms, 2 * ms + 90_000),
        ("kernel", "void ntt_fwd_kernel<14>", 3 * ms, 3 * ms + 100_000),
        ("kernel", "elementwise_kernel", 4 * ms, 6 * ms),
        ("kernel", "elementwise_kernel", 6 * ms, 7 * ms),
        ("kernel", "void ntt_inv_kernel<14>", 12 * ms, 12 * ms + 50_000),
        ("kernel", "reduce_kernel", 13 * ms, 14 * ms),
    ]
    spans = [("server_step", 1 * ms, 8 * ms), ("client_decrypt", 11 * ms, 15 * ms),
             ("exchange", 0, 16 * ms)]
    t = run.Trace(0, 20 * ms, 2, ops, spans, [(1 * ms, 7000)])
    r = run.Run({}, {}, shape={"H": 2, "D": 12, "P": 12, "L": 6, "N": 16384}, trace=t)
    return r


@pytest.mark.parametrize("name, want", [
    ("server_step_ms", 3.5),
    ("server_glue_ms", 1.5),              # the two elementwise kernels, over 2 sets
    ("server_kernels_per_set", 1.0),
    ("k1_ms", 0.075),                     # both NTTs, the client's included
    ("k2_roofline", 100 * 0.0451 / 0.09),
    ("client_decrypt_ms", 2.0),
    ("device_idle_share", 100 * (1 - (1 + 0.09 + 0.1 + 3 + 0.05 + 1) / 20)),
])
def test_readers_on_a_made_up_trace(name, want):
    assert spec.reader(REPO, name)(made_up_run()) == pytest.approx(want, rel=2e-3)


@pytest.mark.parametrize("name", ["server_step_ms", "server_glue_ms", "k2_roofline",
                                  "client_decrypt_ms", "device_idle_share", "k1_ms"])
def test_readers_find_nothing_without_a_trace(name):
    assert spec.reader(REPO, name)(run.Run({}, {})) is None


def test_breakdown_names_gaps_by_the_span_the_host_was_in():
    b = run._breakdown(made_up_run().trace)
    assert b["device_ops"][0][0] == "elementwise_kernel" and len(b["device_ops"]) == 6
    gaps = [(n, round(s * 1e3, 2)) for n, s in b["idle_gaps"]]
    assert gaps == [("between_exchanges", 6.0), ("exchange", 5.0), ("exchange", 1.0),
                    ("client_decrypt", 0.95), ("server_step", 0.91), ("server_step", 0.9)]
