"""The port's end-to-end bench (``benchmarks/bench_e2e_psi.py`` of the port)
on the CPU at a tiny geometry (``--device cpu``, ring 128 through
``NHPSI_RING_DIM``), against the JAX package's bench and profiling module.

``--buildOnly`` then ``--resume`` in a fresh process verifies the
intersection; an artifact and sidecar written by the JAX bench's own code
resume through the port's ``--resume`` and the port's through the JAX
bench's. The three faults of the JAX bench stay repaired in the port's: a
path without ``.npz`` is written as given and its size reported, a server
failure in ``--buildOnly`` surfaces as the server's exception (not the
client's ConnectionError), and one function writes the sidecar, with the
JAX bench's keys and dtypes. ``utils.profiling`` is held equal to the JAX
package's. The JAX bench is imported from its file
(``importlib.util.spec_from_file_location``); it is never edited.
"""

import dataclasses
import importlib.util
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from nested_hashing_psi_tpu.config import HashTableParams as JHashTableParams
from nested_hashing_psi_tpu.config import PSIParams as JPSIParams
from nested_hashing_psi_tpu.utils import profiling as j_prof
from nested_hashing_psi_tpu_torch.benchmarks import bench_e2e_psi as bench
from nested_hashing_psi_tpu_torch.benchmarks import profile_build
from nested_hashing_psi_tpu_torch.protocol import batched_fhe as t_proto
from nested_hashing_psi_tpu_torch.utils import profiling as t_prof

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RING = "128"
ROW = ["--server-log2", "9", "--client-log2", "4", "--device", "cpu"]  # inner 5x5, batch 34
SIDECAR_KEYS = ["client_table", "expected", "idx", "minus", "s_mont", "s_ntt"]


@pytest.fixture
def ring128(monkeypatch):
    monkeypatch.setenv("NHPSI_RING_DIM", RING)


def _fresh_resume(path, *extra):
    """``python -m ...bench_e2e_psi --resume path --device cpu`` in a fresh
    interpreter."""
    env = dict(os.environ, PYTHONPATH=REPO, NHPSI_RING_DIM=RING)
    return subprocess.run(
        [sys.executable, "-m", "nested_hashing_psi_tpu_torch.benchmarks.bench_e2e_psi",
         "--resume", path, "--device", "cpu", *extra],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=300)


def _jax_bench():
    spec = importlib.util.spec_from_file_location(
        "jax_bench_e2e_psi", os.path.join(REPO, "benchmarks", "bench_e2e_psi.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_build_only_then_fresh_process_resume(ring128, tmp_path, capsys):
    """A path without .npz is written as given (no suffix appended), the
    printed size is the file's; a fresh process resumes and verifies."""
    art = str(tmp_path / "artifact")
    assert bench.main(ROW + ["--checkpoint", art, "--buildOnly"]) == 0
    out = capsys.readouterr().out
    assert os.path.exists(art) and not os.path.exists(art + ".npz")
    assert os.path.exists(bench.sidecar_path(art))
    assert f"({os.path.getsize(art)} bytes = " in out
    assert f"client sidecar {os.path.getsize(bench.sidecar_path(art))} bytes" in out
    result = str(tmp_path / "result.npy")
    res = _fresh_resume(art, "--resultOut", result)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESUME RESULT: Set matches!" in res.stdout and "|intersection| 8)" in res.stdout
    assert '"pie_ip": 0' in res.stdout  # the CPU runs the plain versions: no launch
    got = np.load(result)
    assert got.dtype == np.uint32 and got.shape[:2] == (5, 2)


def test_full_run_with_checkpoint_and_one_sidecar_writer(ring128, tmp_path, capsys, monkeypatch):
    """The in-process run verifies, saves and resumes bit-exactly; the run
    and --buildOnly write the sidecar through the one writer."""
    calls = []
    real = bench.write_sidecar
    monkeypatch.setattr(bench, "write_sidecar", lambda path, client: (calls.append(path),
                                                                      real(path, client)))
    art = str(tmp_path / "run.npz")
    assert bench.main(ROW + ["--checkpoint", art]) == 0
    out = capsys.readouterr().out
    assert "RESULT: Set matches!" in out and "resumed online query bit-exact" in out
    assert f"({os.path.getsize(art)} bytes)" in out
    assert bench.main(ROW + ["--checkpoint", str(tmp_path / "b.npz"), "--buildOnly"]) == 0
    assert calls == [bench.sidecar_path(art), bench.sidecar_path(str(tmp_path / "b.npz"))]


def test_build_only_raises_the_server_exception(ring128, tmp_path, monkeypatch):
    """A server failing in its offline phase poisons the channel; the bench
    raises the server's exception, not the client's ConnectionError."""
    def broken(self):
        raise RuntimeError("injected server fault")

    monkeypatch.setattr(t_proto.BatchedFHEPSIServer, "run_offline_phase", broken)
    with pytest.raises(RuntimeError, match="injected server fault"):
        bench.main(ROW + ["--checkpoint", str(tmp_path / "a.npz"), "--buildOnly"])
    assert not os.path.exists(tmp_path / "a.npz")


@pytest.fixture(scope="module")
def jax_artifact(tmp_path_factory):
    """The JAX bench's --buildOnly (its own build_only_main, which writes the
    v3 file and the sidecar) at the port test's geometry and ring."""
    jb = _jax_bench()
    args = bench.parse_args(ROW)
    psi, ht = bench.make_params(args)  # ring 16384 here; the JAX side takes 128
    jpsi = JPSIParams(**{**dataclasses.asdict(psi), "ring_dim": int(RING), "verbose": False})
    jht = JHashTableParams(**dataclasses.asdict(ht))
    path = str(tmp_path_factory.mktemp("jax_art") / "jax.npz")
    assert jb.build_only_main(types.SimpleNamespace(checkpoint=path), jpsi, jht) == 0
    return jb, path


def test_jax_artifact_resumes_in_the_port(jax_artifact, tmp_path):
    _, path = jax_artifact
    res = _fresh_resume(path)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "RESUME RESULT: Set matches!" in res.stdout and "|intersection| 8)" in res.stdout


def test_port_artifact_resumes_in_the_jax_bench(jax_artifact, ring128, tmp_path, capsys):
    """The port's files through the JAX bench's resume_main; the port's
    sidecar has the JAX bench's keys, dtypes and shapes."""
    jb, jpath = jax_artifact
    art = str(tmp_path / "port.npz")
    assert bench.main(ROW + ["--checkpoint", art, "--buildOnly"]) == 0
    with np.load(bench.sidecar_path(art)) as zp, np.load(bench.sidecar_path(jpath)) as zj:
        assert sorted(zp.files) == sorted(zj.files) == SIDECAR_KEYS
        for k in SIDECAR_KEYS:
            assert (zp[k].dtype, zp[k].shape) == (zj[k].dtype, zj[k].shape), k
        np.testing.assert_array_equal(zp["expected"], zj["expected"])
        np.testing.assert_array_equal(zp["client_table"], zj["client_table"])
    capsys.readouterr()
    assert jb.resume_main(types.SimpleNamespace(resume=art)) == 0
    assert "RESUME RESULT: Set matches!" in capsys.readouterr().out


def test_profiler_spans_like_jax(tmp_path):
    reports = []
    for mod in (t_prof, j_prof):
        prof = mod.Profiler()
        with prof.span("outer"):
            with prof.span("inner"):
                pass
        assert [s.name for s in prof.spans] == ["inner", "outer"]
        assert all(s.duration_us >= 0 and s.end_ns >= s.start_ns for s in prof.spans)
        reports.append(sorted(prof.report()))
    assert reports[0] == reports[1]
    # the JAX fields first, in order; the port's tracer adds its own after them
    j_fields = [f.name for f in j_prof.Span.__dataclass_fields__.values()]
    assert [f.name for f in t_prof.Span.__dataclass_fields__.values()][:len(j_fields)] == j_fields
    with t_prof.device_trace(str(tmp_path / "trace")):
        torch.ones(4).add_(1)
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0


def test_profile_build_stages(monkeypatch, capsys):
    """The build profiler's four stages at a tiny scale on the CPU; the
    insert and the encode are read from the build's own spans, the ones
    the server's offline phase opens (no device events on the CPU)."""
    monkeypatch.setenv("NHPSI_RING_DIM", RING)
    out = profile_build.main(["11", "--simpleSize", "32", "--inner", "8", "--device", "cpu"])
    assert (out["inner"], out["ring"], out["table_bytes"]) == (8, 128, 2 * 8 * 8 * out["L"] * 128 * 4)
    assert min(out[k] for k in ("gen_s", "hash_s", "insert_s", "encode_s")) > 0
    assert out["rows"] == 2 * 8 * 8 + 8 and out["rounds"] > 0
    assert out["insert_device_ms"] is None and out["encode_device_ms"] is None
    spans = {s.name: s for s in t_prof.TRACER.spans}
    assert spans["build.encode"].counts == {"rows": out["rows"]}
    assert "insert (device)" in capsys.readouterr().out
