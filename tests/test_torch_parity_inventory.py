"""Every public name of the JAX package has its counterpart in the port.

An ``ast`` walk, importing neither package, over every module of
``nested_hashing_psi_tpu/``, the root ``benchmarks/``, ``bench.py`` and
``__graft_entry__.py``: each public top-level function and class, and each
public method of such a class (defined in its body), must exist at the
same path in ``nested_hashing_psi_tpu_torch/`` (the root ``benchmarks/``
and ``bench.py`` map to the port's ``benchmarks/``), or be listed in one of
two tables below: ``RENAMED`` (the port does the same job under another
name or module; the target must exist) or ``JAX_ONLY`` (with the reason
the port has no counterpart). A table entry whose name the port has at
the same path, or that the JAX package no longer has, is stale and fails.
"""

import ast
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "nested_hashing_psi_tpu", "nested_hashing_psi_tpu_torch"


def _jax_modules() -> list[str]:
    mods = []
    for root, dirs, files in os.walk(os.path.join(REPO, JAX_PKG)):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        mods += [os.path.relpath(os.path.join(root, f), REPO) for f in files if f.endswith(".py")]
    bench = os.path.join(REPO, "benchmarks")
    mods += [f"benchmarks/{f}" for f in os.listdir(bench) if f.endswith(".py")]
    return sorted(mods) + ["bench.py", "__graft_entry__.py"]


def _port_path(jax_rel: str) -> str | None:
    if jax_rel.startswith(JAX_PKG + "/"):
        return PORT_PKG + jax_rel[len(JAX_PKG):]
    if jax_rel.startswith("benchmarks/"):
        return f"{PORT_PKG}/{jax_rel}"
    if jax_rel == "bench.py":  # the root bench is the port's benchmarks/bench.py
        return f"{PORT_PKG}/benchmarks/bench.py"
    return None  # __graft_entry__.py: the TPU entry hooks


def public_names(rel: str) -> set[str]:
    """Public top-level functions and classes of a module, and the public
    methods defined in each such class's body, as ``name`` / ``Class.method``."""
    path = os.path.join(REPO, rel)
    if not os.path.exists(path):
        return set()
    with open(path) as f:
        tree = ast.parse(f.read(), filename=rel)
    defs = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    out = set()
    for node in tree.body:
        if isinstance(node, defs) and not node.name.startswith("_"):
            out.add(node.name)
            if isinstance(node, ast.ClassDef):
                out |= {f"{node.name}.{m.name}" for m in node.body
                        if isinstance(m, defs[:2]) and not m.name.startswith("_")}
    return out


def _jp(rel):
    return f"{JAX_PKG}/{rel}"


def _pp(rel):
    return f"{PORT_PKG}/{rel}"


# (JAX module, name) -> (port module, name): the same capability renamed
RENAMED = {
    (_jp("ops/ntt_pallas.py"), "ntt_pallas"): (_pp("ops/ntt_cuda.py"), "ntt"),  # K1
    (_jp("ops/ntt_pallas.py"), "intt_pallas"): (_pp("ops/ntt_cuda.py"), "intt"),
    # the split form's plain (jnp) transform: the port's plain NTT
    (_jp("ops/ntt_pallas.py"), "ntt_split"): (_pp("ops/ntt.py"), "ntt"),
    (_jp("ops/ntt_pallas.py"), "intt_split"): (_pp("ops/ntt.py"), "intt"),
    (_jp("ops/ntt_pallas.py"), "SplitNTTPlan"): (_pp("ops/split_plan.py"), "SplitNTTPlan"),
    (_jp("ops/ntt_pallas.py"), "SplitNTTPlan.L"): (_pp("ops/split_plan.py"), "SplitNTTPlan.L"),
    # one split-form stage; the butterfly (ct_exact / gs_exact) is an argument
    (_jp("ops/ntt_pallas.py"), "ct_stage"): ("benchmarks/u32.py", "split_stage"),
    (_jp("ops/ntt_pallas.py"), "gs_stage"): ("benchmarks/u32.py", "split_stage"),
    (_jp("ops/ntt_mxu.py"), "ntt_mxu_pallas"): (_pp("ops/ntt_mxu.py"), "ntt_mxu"),  # K3
    (_jp("ops/ntt_mxu.py"), "intt_mxu_pallas"): (_pp("ops/ntt_mxu.py"), "intt_mxu"),
    (_jp("ops/pie_kernels.py"), "indexed_inner_product_jnp"):
        (_pp("ops/pie_kernels.py"), "indexed_inner_product_plain"),  # K2's plain version
    # the probes: what the Pallas kernel factories return is the CUDA wrappers' job
    ("benchmarks/bench_vpu_ops.py", "make"): ("benchmarks/bench_vpu_ops.py", "vpu_ops"),
    ("benchmarks/bench_ntt_lazy_probe.py", "make_variant"):
        ("benchmarks/bench_ntt_lazy_probe.py", "lazy_probe"),
    ("benchmarks/bench_ntt_anatomy.py", "make_variant"):
        ("benchmarks/bench_ntt_anatomy.py", "anatomy_probe"),
    ("benchmarks/bench_ntt_lazy_probe.py", "shoup_lazy"): ("benchmarks/u32.py", "shoup_lazy"),
    ("benchmarks/bench_ntt_lazy_probe.py", "mulhi_presplit"):
        ("benchmarks/u32.py", "mulhi_presplit"),
    # the lazy pre-split Shoup product, inside the lazy_ps butterfly
    ("benchmarks/bench_ntt_lazy_probe.py", "shoup_lazy_presplit"):
        ("benchmarks/bench_ntt_lazy_probe.py", "_ct_lazy_ps"),
    # chained calls timed: the port's one timing module
    ("benchmarks/bench_ntt_f32mxu.py", "rate"): ("benchmarks/timing.py", "chain"),
    # the sp step's transform count, repaired to the flat product it runs
    ("benchmarks/comm_model.py", "transforms_per_query"):
        ("benchmarks/comm_model.py", "sp_transforms"),
    ("benchmarks/profile_online.py", "hps_parts"): ("benchmarks/profile_online.py", "hps_rows"),
    ("bench.py", "bench_ntt"): ("benchmarks/bench.py", "ntt_rates"),
    ("bench.py", "bench_pie_online"): ("benchmarks/bench.py", "pie_online"),
}
RENAMED = {k: (_pp(v[0]) if v[0].startswith("benchmarks/") else v[0], v[1])
           for k, v in RENAMED.items()}

# (JAX module, name) -> why the port has no counterpart
JAX_ONLY = {
    (_jp("ops/ntt.py"), "NTTPlan.ntt_jit"):
        "a jax.jit compile cache on the plan; the port calls ops.ntt.ntt or K1 directly",
    (_jp("ops/ntt.py"), "NTTPlan.intt_jit"): "as ntt_jit",
    (_jp("fhe/bgv.py"), "Ciphertext.tree_flatten"):
        "JAX pytree registration; a torch Ciphertext is a plain dataclass",
    (_jp("fhe/bgv.py"), "Ciphertext.tree_unflatten"): "as tree_flatten",
    (_jp("protocol/channel.py"), "LoopbackChannel.read_tensor"):
        "the pass_device_arrays option, left out on purpose: the port's loopback "
        "serializes every frame through Channel.read_tensor/write_tensor, as TCP does",
    (_jp("protocol/channel.py"), "LoopbackChannel.write_tensor"): "as read_tensor",
    (_jp("utils/profiling.py"), "batched_pie_op_counts"):
        "a static op count its docstring calls rough, read by no metric; the port's "
        "benchmark times the kernels (psi_bench/) and K2's bound is benchmarks/card.py's",
    (_jp("utils/jaxcache.py"), "enable_persistent_cache"):
        "JAX's persistent XLA compilation cache; the port compiles nothing at run time "
        "but its CUDA kernels, built once into build/ by ops/cuda_lib.py",
    ("__graft_entry__.py", "entry"):
        "the TPU compile-check hook (a jittable forward); on the card "
        "tests/test_torch_kernels_gpu.py::test_protocols_at_ring_16384_through_the_entry_points "
        "drives the port's entry points",
    ("__graft_entry__.py", "dryrun_multichip"):
        "the TPU virtual-mesh dry run; the port's sharded steps run on "
        "torch.distributed ranks (parallel/, tests/torch_parallel_cases.py)",
}

# the names ported last: counterparts at the same path, never table entries
PORTED_LAST = [
    (_jp("ops/basis.py"), "BasisExtension"), (_jp("ops/basis.py"), "BasisExtension.convert"),
    (_jp("utils/native.py"), "cuckoo_insert_seq"),
    *((_jp("ops/refmodel.py"), n) for n in ("ntt_numpy", "intt_numpy",
                                            "negacyclic_mul_naive", "default_psi")),
    *((_jp("ops/modmath.py"), n) for n in ("mulhi_u32", "from_mont", "mul_mod",
                                           "to_mont_host")),
    (_jp("fhe/bgv.py"), "tensor_product_mont"),
]


@pytest.mark.parametrize("jax_rel", _jax_modules())
def test_every_public_name_has_a_counterpart(jax_rel):
    port_rel = _port_path(jax_rel)
    port = public_names(port_rel) if port_rel else set()
    missing = []
    for name in sorted(public_names(jax_rel)):
        key = (jax_rel, name)
        if name in port or key in JAX_ONLY:
            continue
        if key in RENAMED:
            target_rel, target = RENAMED[key]
            module = os.path.join(REPO, target_rel)
            assert os.path.exists(module), f"{name}: renamed target {target_rel} is missing"
            with open(module) as f:
                tree = ast.parse(f.read())
            top = {n.name: n for n in tree.body if hasattr(n, "name")}
            head, _, method = target.partition(".")
            found = head in top and (not method or any(
                getattr(m, "name", None) == method for m in top[head].body))
            assert found, f"{name}: renamed target {target_rel}:{target} does not exist"
            continue
        missing.append(name)
    assert not missing, f"{jax_rel}: no counterpart in {port_rel} and in no table: {missing}"


@pytest.mark.parametrize("table", ["RENAMED", "JAX_ONLY"])
def test_table_entries_are_not_stale(table):
    """Every entry names a public name the JAX package has and the port
    lacks at the same path; every JAX-only entry gives a reason."""
    entries = RENAMED if table == "RENAMED" else JAX_ONLY
    for (jax_rel, name), value in entries.items():
        assert name in public_names(jax_rel), f"{jax_rel}:{name} is not in the JAX package"
        port_rel = _port_path(jax_rel)
        assert not port_rel or name not in public_names(port_rel), \
            f"{jax_rel}:{name} has a counterpart at the same path; drop the entry"
        assert value and all(value), (jax_rel, name)


def test_last_ported_names_are_counterparts():
    for jax_rel, name in PORTED_LAST:
        assert (jax_rel, name) not in RENAMED and (jax_rel, name) not in JAX_ONLY
        assert name in public_names(jax_rel)
        assert name in public_names(_port_path(jax_rel)), f"{name} missing from the port"
