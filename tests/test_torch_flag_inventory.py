"""Every command-line flag of the JAX package's tools has its counterpart in
the port.

An ``ast`` walk, importing neither package, over every ``add_argument``
call of the JAX tools (``cli.py`` and ``config.py``'s parser,
``hashing/evaluation.py``, ``bench.py`` and the root ``benchmarks/``) and of
their port counterparts (the root ``benchmarks/`` and ``bench.py`` map to
the port's ``benchmarks/``, as in ``test_torch_parity_inventory.py``). Each
JAX flag must exist in the port with every option string, the same
``type``, ``action``, ``default`` and ``choices``, or be listed in
``DIVERGES`` with the reason. An entry whose flag the JAX tool no longer
has, or that the port now matches, is stale and fails. Flags only the port
has (``--device``, ``--ranks``, ``--backend``, ...) are allowed.
"""

import ast
import os

import pytest

from test_torch_parity_inventory import JAX_PKG, REPO, _port_path

FIELDS = ("type", "action", "default", "choices")


def _tools() -> list[str]:
    bench = sorted(f"benchmarks/{f}" for f in os.listdir(os.path.join(REPO, "benchmarks"))
                   if f.endswith(".py"))
    return [f"{JAX_PKG}/cli.py", f"{JAX_PKG}/config.py", f"{JAX_PKG}/hashing/evaluation.py",
            "bench.py", *bench]


def _value(node):
    """A keyword's value: the literal where it is one, else its source."""
    try:
        return ast.literal_eval(node)
    except ValueError:
        return ast.unparse(node)


def flags_of(source: str) -> dict:
    """option (the first ``--`` string, else the positional name) ->
    {"names": every option string, and each of FIELDS given}; ``type=str``
    and ``action="store"`` are argparse's defaults and count as absent."""
    out = {}
    for node in ast.walk(ast.parse(source)):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        names = tuple(a.value for a in node.args if isinstance(a, ast.Constant))
        spec = {k.arg: _value(k.value) for k in node.keywords if k.arg in FIELDS}
        if spec.get("type") == "str":
            del spec["type"]
        if spec.get("action") == "store":
            del spec["action"]
        out[next((n for n in names if n.startswith("--")), names[0])] = {"names": names, **spec}
    return out


def _flags(rel: str) -> dict:
    path = os.path.join(REPO, rel)
    if not os.path.exists(path):
        return {}
    with open(path) as f:
        return flags_of(f.read())


def flag_problems(jax_flags: dict, port_flags: dict, diverges: set) -> list[str]:
    """Each JAX flag the port lacks, or has otherwise than the JAX tool
    without a ``diverges`` entry; each ``diverges`` entry that is stale."""
    out = []
    for opt, spec in jax_flags.items():
        got = port_flags.get(opt)
        if got is None:
            out.append(f"{opt}: no port counterpart")
            continue
        missing = set(spec["names"]) - set(got["names"])
        differs = [k for k in FIELDS if spec.get(k) != got.get(k)]
        if missing:
            out.append(f"{opt}: the port lacks the option strings {sorted(missing)}")
        if differs and opt not in diverges:
            out.append(f"{opt}: {differs} differ: JAX {spec}, port {got}")
        if not differs and opt in diverges:
            out.append(f"{opt}: listed in DIVERGES but the port matches the JAX tool")
    out += [f"{opt}: listed in DIVERGES but the JAX tool has no such flag"
            for opt in sorted(diverges - set(jax_flags))]
    return out


# (JAX tool, flag) -> why the port's flag differs from the JAX tool's
DIVERGES = {
    ("benchmarks/comm_model.py", "--t1-ms"):
        "the JAX default is a TPU time (K1's ms per transform on the TPU); the port "
        "models the card from a reading the caller passes, so it has no default",
    ("benchmarks/comm_model.py", "--t1-ns-ms"): "as --t1-ms: a TPU time, dropped",
    ("benchmarks/run_eval.py", "--params"):
        "the JAX default is the reference checkout's Parameters1.txt, which is not in "
        "the repository; the port's flag is required",
    ("benchmarks/run_eval.py", "--outdir"):
        "the port writes under eval_results_torch/ (timing.EVAL_DIR), never the JAX "
        "package's eval_results/",
    ("benchmarks/scaling_report.py", "--tp"):
        "one rank per process: the default is 2 for --ranks, as the JAX tool's, and 1 with "
        "--num-processes, where tp stays within a process as the JAX package keeps it "
        "within a host",
}


@pytest.mark.parametrize("jax_rel", _tools())
def test_every_jax_flag_has_its_port_counterpart(jax_rel):
    diverges = {opt for rel, opt in DIVERGES if rel == jax_rel}
    problems = flag_problems(_flags(jax_rel), _flags(_port_path(jax_rel)), diverges)
    assert not problems, f"{jax_rel} against {_port_path(jax_rel)}: {problems}"


def test_diverges_entries_name_a_tool_and_give_a_reason():
    tools = set(_tools())
    for (rel, opt), reason in DIVERGES.items():
        assert rel in tools and opt in _flags(rel), (rel, opt)
        assert reason


def test_the_walk_sees_the_multi_process_flags():
    """The JAX tool's multi-host flags are in the walk, and in the port."""
    jax = _flags("benchmarks/scaling_report.py")
    port = _flags(_port_path("benchmarks/scaling_report.py"))
    for opt in ("--coordinator", "--num-processes", "--process-id", "--cpu", "--iters"):
        assert opt in jax and port[opt] == jax[opt], opt
    assert {"--backend", "--device", "--ranks"} <= set(port) - set(jax)


_JAX_SRC = """
ap.add_argument("--ring", type=int, default=256)
ap.add_argument("-v", "--verbose", action="store_true")
ap.add_argument("--mode", default="a", choices=["a", "b"])
"""


@pytest.mark.parametrize("port_src,diverges,expect", [
    (_JAX_SRC, set(), []),
    (_JAX_SRC.replace('"--mode", ', '"--mode", type=str, action="store", '), set(), []),
    (_JAX_SRC.replace("256", "512"), set(), ["--ring: ['default'] differ"]),
    (_JAX_SRC.replace("256", "512"), {"--ring"}, []),
    (_JAX_SRC.replace("type=int", "type=float"), set(), ["--ring: ['type'] differ"]),
    (_JAX_SRC.replace('"-v", ', ""), set(), ["--verbose: the port lacks the option strings"]),
    (_JAX_SRC.replace('["a", "b"]', '["a"]'), set(), ["--mode: ['choices'] differ"]),
    (_JAX_SRC.replace('ap.add_argument("--ring", type=int, default=256)', ""), set(),
     ["--ring: no port counterpart"]),
    (_JAX_SRC, {"--ring"}, ["--ring: listed in DIVERGES but the port matches"]),
    (_JAX_SRC, {"--gone"}, ["--gone: listed in DIVERGES but the JAX tool has no such flag"]),
    (_JAX_SRC + 'ap.add_argument("--device", default="cuda")\n', set(), []),
], ids=["equal", "argparse_defaults", "default", "default_listed", "type", "alias", "choices",
        "missing", "stale_equal", "stale_gone", "port_only"])
def test_the_walk_on_a_synthetic_pair(port_src, diverges, expect):
    got = flag_problems(flags_of(_JAX_SRC), flags_of(port_src), diverges)
    assert len(got) == len(expect) and all(g.startswith(e) for g, e in zip(got, expect)), got
