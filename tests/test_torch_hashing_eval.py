"""The port's cuckoo failure-rate evaluations against the JAX package's.

``nested_hashing_psi_tpu_torch.hashing.evaluation`` is a host-only copy:
for the same arguments its ``evaluate_flat`` and ``evaluate_nested`` rows
(slack, effective slack, failures) must equal the JAX functions' exactly
(the same Philox-seeded items and integer hashing; the effective slack is
the same float expression). ``tests/test_hashing_eval.py``'s three
envelopes hold on the port too, and ``main`` writes its CSV under
``eval_results_torch/`` unless ``--out`` names a file.
"""

import os

import pytest

from nested_hashing_psi_tpu.hashing.evaluation import evaluate_flat as j_flat
from nested_hashing_psi_tpu.hashing.evaluation import evaluate_nested as j_nested
from nested_hashing_psi_tpu_torch.benchmarks import timing
from nested_hashing_psi_tpu_torch.hashing import evaluation as t_eval

FLAT_CASES = {
    "n256-stash0": dict(n_elem=256, n_runs=3, stash=0, n_cuckoo_hf=2, items_pp=1,
                        slacks=(1.0, 1.2, 2.0)),
    "n512-stash2-pp2": dict(n_elem=512, n_runs=2, stash=2, n_cuckoo_hf=2, items_pp=2,
                            slacks=(1.05, 1.5)),
    "n300-3hf-seeds": dict(n_elem=300, n_runs=2, stash=1, n_cuckoo_hf=3, items_pp=1,
                           slacks=(1.0, 1.1), item_seed=7, hash_seed=99),
}
NESTED_CASES = {
    "n1024-e32": dict(n_elem=1024, n_runs=2, each_simple_table_size=32, stash=2,
                      n_simple_hf=2, n_cuckoo_hf=2, slacks=(1.1, 1.4)),
    "n512-e16-3hf-frac2": dict(n_elem=512, n_runs=2, each_simple_table_size=16, stash=0,
                               n_simple_hf=3, n_cuckoo_hf=2, item_pp_frac=2.0,
                               slacks=(1.0, 1.3)),
}


@pytest.mark.parametrize("case", list(FLAT_CASES))
def test_flat_rows_equal_jax(case):
    kw = FLAT_CASES[case]
    assert t_eval.evaluate_flat(**kw) == j_flat(**kw)


@pytest.mark.parametrize("case", list(NESTED_CASES))
def test_nested_rows_equal_jax(case):
    kw = NESTED_CASES[case]
    assert t_eval.evaluate_nested(**kw) == j_nested(**kw)


def _flat_failure_envelope():
    rows = t_eval.evaluate_flat(n_elem=2048, n_runs=4, stash=0, n_cuckoo_hf=2, items_pp=1,
                                slacks=(1.0, 1.4, 2.0))
    by_slack = {r[0]: r[2] for r in rows}
    assert by_slack[1.0] == 4  # slack 1.0, no stash: always fails
    assert by_slack[2.0] == 0  # 2x slack, 2 hash fns: never fails


def _nested_failure_envelope():
    rows = t_eval.evaluate_nested(n_elem=4096, n_runs=3, each_simple_table_size=32, stash=2,
                                  n_simple_hf=2, n_cuckoo_hf=2, slacks=(1.2, 1.4))
    assert rows[-1][2] == 0  # generous slack: no failures


def _stash_rescues_marginal_config():
    def failures(stash):
        return t_eval.evaluate_flat(n_elem=1024, n_runs=6, stash=stash, n_cuckoo_hf=2,
                                    items_pp=2, slacks=(1.05,))[0][2]

    assert failures(4) <= failures(0)


@pytest.mark.parametrize("envelope", [_flat_failure_envelope, _nested_failure_envelope,
                                      _stash_rescues_marginal_config],
                         ids=["flat_failure", "nested_failure", "stash_rescues"])
def test_envelopes_of_test_hashing_eval_hold_on_the_port(envelope):
    """tests/test_hashing_eval.py's three envelopes, on the port."""
    envelope()


def test_main_writes_to_out_or_eval_results_torch(tmp_path, monkeypatch):
    out = tmp_path / "flat.csv"
    assert t_eval.main(["cuckoo", "--nElem", "128", "--nRuns", "1", "--out", str(out)]) == \
        str(out)
    rows = t_eval.evaluate_flat(128, 1)
    assert out.read_text() == "".join(f"{s},{e},{f}\n" for s, e, f in rows)
    # the default lands in eval_results_torch/ (here redirected), never the cwd
    monkeypatch.setattr(timing, "EVAL_DIR", str(tmp_path / "eval_results_torch"))
    monkeypatch.chdir(tmp_path)
    path = t_eval.main(["nested", "--nElem", "256", "--nRuns", "1",
                        "--eachSimpleTableSize", "16"])
    assert os.path.dirname(path) == str(tmp_path / "eval_results_torch")
    assert os.path.basename(path) == "NCT_nE_256_nR_1_eSs_16_sts_2_nSH_3_nCH_2_frac_1.0.csv"
    assert sorted(os.listdir(tmp_path)) == ["eval_results_torch", "flat.csv"]
