"""Every test of the JAX package has its counterpart among the port's tests.

An ``ast`` walk, importing nothing, over the test functions of the JAX
package's own test files (``tests/test_*.py`` without ``torch`` in the
name) and of the port's (``tests/test_torch_*.py``). A JAX test
``test_X.py::f`` is mirrored by ``test_torch_X.py::f`` where that exists;
otherwise ``MIRRORS`` names the port test that checks the same behaviour
(``file::function``, which must exist), or ``NOT_MIRRORED`` gives the
reason there is none. A table entry for a JAX test that no longer exists,
one that the same-name rule already covers, or a ``MIRRORS`` target that
does not exist, is stale and fails. A port test may mirror several JAX
tests; the GPU tests (``test_torch_kernels_gpu.py``, marker ``gpu``) run on
the card.
"""

import ast
import os

import pytest

from test_torch_parity_inventory import REPO

TESTS = os.path.join(REPO, "tests")


def names_of_tests(source: str) -> list[str]:
    """The test functions of a module: top-level ``test_*`` functions and
    the ``test_*`` methods of its ``Test*`` classes (as ``Class.method``)."""
    out = []
    for node in ast.parse(source).body:
        if isinstance(node, ast.FunctionDef) and node.name.startswith("test_"):
            out.append(node.name)
        elif isinstance(node, ast.ClassDef) and node.name.startswith("Test"):
            out += [f"{node.name}.{m.name}" for m in node.body
                    if isinstance(m, ast.FunctionDef) and m.name.startswith("test_")]
    return out


def _collect(port: bool) -> list[str]:
    out = []
    for f in sorted(os.listdir(TESTS)):
        if f.startswith("test_") and f.endswith(".py") and ("torch" in f) == port:
            with open(os.path.join(TESTS, f)) as fh:
                out += [f"{f}::{t}" for t in names_of_tests(fh.read())]
    return out


def same_name(jax_test: str) -> str:
    """``test_X.py::f`` -> ``test_torch_X.py::f``."""
    return "test_torch_" + jax_test[len("test_"):]


def inventory_problems(jax_tests: list, port_tests: set, mirrors: dict,
                       not_mirrored: dict) -> list[str]:
    """Each JAX test with no counterpart, and each stale table entry."""
    out = []
    for t in jax_tests:
        listed = [name for name, table in (("MIRRORS", mirrors), ("NOT_MIRRORED", not_mirrored))
                  if t in table]
        if same_name(t) in port_tests:
            out += [f"{t}: in {name}, but {same_name(t)} mirrors it" for name in listed]
        elif not listed:
            out.append(f"{t}: no port test mirrors it and no table lists it")
        elif len(listed) > 1:
            out.append(f"{t}: in both tables")
        elif t in mirrors and mirrors[t] not in port_tests:
            out.append(f"{t}: its mirror {mirrors[t]} does not exist")
        elif t in not_mirrored and not not_mirrored[t]:
            out.append(f"{t}: NOT_MIRRORED gives no reason")
    known = set(jax_tests)
    out += [f"{t}: listed, but the JAX package has no such test"
            for t in sorted((set(mirrors) | set(not_mirrored)) - known)]
    return out


B, BFV, BGVR = "test_torch_basis_extension.py", "test_torch_bfv.py", "test_torch_bgv_roundtrips.py"
E2E, GPU, EG = "test_torch_protocol_e2e.py", "test_torch_kernels_gpu.py", "test_torch_elgamal.py"
HC, HM, MN = "test_torch_host_copies.py", "test_torch_host_modules.py", "test_torch_modmath_ntt.py"
PH = "test_torch_parity_helpers.py"

# JAX test -> the port test that checks the same behaviour (on the port's own
# objects, or bit-equal with the JAX package on the same inputs)
MIRRORS = {
    "test_basis.py::test_exact_conversion": f"{B}::test_exact_conversion",
    "test_basis.py::test_batched_shapes": f"{B}::test_batched_shapes",
    "test_basis.py::test_lazy_conversion_overflow_bound":
        f"{B}::test_lazy_conversion_overflow_bound",
    "test_basis.py::test_roundtrip_through_aux_basis": f"{B}::test_roundtrip_through_aux_basis",
    "test_basis.py::test_mulconv_base_sizing": f"{BFV}::test_mulconv_base_sizing",
    "test_basis.py::test_mulconv_extend_centered": f"{BFV}::test_mulconv_extend_centered",
    "test_basis.py::test_mulconv_exact_to_q_full_range":
        f"{BFV}::test_mulconv_exact_to_q_full_range",
    "test_basis.py::test_mulconv_scale_round_oracle": f"{BFV}::test_mulconv_scale_round_oracle",
    "test_batched_pie.py::test_batched_pie_end_to_end":
        "test_torch_batched_pie.py::test_forward_matches_and_decrypts",
    "test_batched_pie.py::test_batched_pie_no_matches":
        f"{E2E}::test_port_run_in_process_empty_intersection",
    "test_batched_pie.py::test_host_table_pie_matches_device":
        "test_torch_batched_pie.py::test_host_table_run_matches_device_table",
    "test_bfv.py::test_factory": "test_torch_bgv.py::test_make_context_takes_the_scheme",
    "test_bfv_rescale.py::test_rns_rescale_oracle":
        "test_torch_basis_bfv.py::test_rns_rescale_matches",
    "test_bfv_rescale.py::test_rns_rescale_single_limb":
        "test_torch_basis_bfv.py::test_rns_rescale_matches",
    "test_bfv_rescale.py::test_rescale_ct_preserves_message":
        f"{BFV}::test_rescale_ct_preserves_message",
    "test_bfv_rescale.py::test_rescaled_pie_matches_full_basis":
        f"{BFV}::test_rescaled_pie_matches_full_basis",
    "test_bfv_rescale.py::test_mul_limb_models": f"{BFV}::test_mul_limb_models",
    "test_bfv_rescale.py::test_ring16384_l6_rescaled_margin":
        f"{BFV}::test_ring16384_l6_rescaled_margin",
    **{f"test_bgv.py::{t}": f"{BGVR}::{t}" for t in (
        "test_encoder_roundtrip_small_t", "test_encoder_roundtrip_big_t",
        "test_encoder_negative_and_padding", "test_encrypt_decrypt_sk", "test_encrypt_decrypt_pk",
        "test_batched_encrypt", "test_homomorphic_add", "test_ct_pt_mul",
        "test_ct_ct_mul_and_relin", "test_depth2_chain", "test_big_t_encrypt_decrypt")},
    "test_channel.py::test_tensor_framing_roundtrip": f"{HM}::test_channel_frames_byte_identical",
    "test_channel.py::test_loopback_counters": f"{HM}::test_loopback_counts_like_jax",
    "test_channel.py::test_tcp_channel_roundtrip": f"{HM}::test_tcp_frames_cross_packages",
    "test_checkpoint.py::test_batched_pie_checkpoint_roundtrip":
        "test_torch_checkpoint.py::test_files_equal_and_resume_across_packages",
    "test_checkpoint.py::test_checkpoint_rejects_unknown_version":
        "test_torch_checkpoint.py::test_rejects_other_versions",
    "test_cli_two_process.py::test_cli_pair_over_tcp": f"{E2E}::test_cli_two_processes_over_tcp",
    "test_device_decrypt.py::test_device_slots_match_host_decrypt":
        "test_torch_device_decrypt.py::test_device_slots_match_jax_and_host_decrypt",
    "test_device_decrypt.py::test_mod64_primitives_random":
        "test_torch_device_decrypt.py::test_mod64_primitive_matches_jax",
    "test_elgamal.py::test_indexed_randomized_equality":
        f"{EG}::test_gadgets_seeded_bytes_equal_jax",
    "test_elgamal.py::test_simple_elgamal_e2e": f"{EG}::test_port_elgamal_run_in_process",
    "test_elgamal.py::test_precomp_elgamal_e2e": f"{EG}::test_port_elgamal_run_in_process",
    "test_elgamal.py::test_simple_elgamal_with_stash": f"{EG}::test_port_elgamal_with_stash",
    "test_elgamal.py::test_elgamal_combined_tables_e2e": f"{EG}::test_port_elgamal_combined_tables",
    "test_elgamal.py::test_elgamal_nthreads_e2e": f"{EG}::test_port_elgamal_nthreads",
    "test_elgamal.py::test_fhe_pie_rejects_combined_tables":
        "test_torch_batched_pie.py::test_fhe_pie_rejects_combined_tables",
    **{f"test_goldens_reference_scale.py::{t}": f"{GPU}::test_reference_golden_at_ring_16384"
       for t in ("test_golden_fhe_pie_15000_items_ring16384",
                 "test_golden_batched_fhe_pie_reference_geometry",
                 "test_golden_inner_product_known_vector_with_serialization")},
    **{f"test_hashing_eval.py::{t}":
       "test_torch_hashing_eval.py::test_envelopes_of_test_hashing_eval_hold_on_the_port"
       for t in ("test_flat_failure_envelope", "test_nested_failure_envelope",
                 "test_stash_rescues_marginal_config")},
    **{f"test_misc_crypto.py::{t}": f"{EG}::{t}" for t in (
        "test_damgard_jurik_roundtrip_and_homomorphism", "test_damgard_jurik_s2",
        "test_aes_ctr_prg_reset_reproduces_stream", "test_dj_socket_pair_equality_protocol")},
    "test_modmath.py::test_mulhi_u32_random": f"{PH}::test_mulhi_u32_full_range",
    "test_modmath.py::test_mont_mul_matches_python": f"{MN}::test_modmath_op_matches_jax",
    "test_modmath.py::test_mont_mul_edge_cases": f"{MN}::test_modmath_op_matches_jax",
    "test_modmath.py::test_add_sub_neg_mod": f"{MN}::test_modmath_op_matches_jax",
    "test_modmath.py::test_to_from_mont_roundtrip": f"{PH}::test_mont_helpers_match_jax",
    "test_modmath.py::test_prime_generation": f"{HC}::test_primes_equal",
    "test_modmath.py::test_primitive_root": f"{HC}::test_primes_equal",
    "test_modmath.py::test_shoup_mul_matches_bigint": f"{MN}::test_modmath_op_matches_jax",
    "test_native.py::test_native_ntt_small_prime_matches_refmodel":
        f"{HM}::test_native_helpers_equal",
    "test_native.py::test_native_ntt_big_modulus_roundtrip": f"{HM}::test_native_helpers_equal",
    "test_native.py::test_native_cuckoo_matches_reference_semantics":
        f"{PH}::test_cuckoo_insert_seq_matches_jax",
    "test_native.py::test_big_t_encoder_uses_native": f"{HC}::test_encoder_equal",
    "test_native_decrypt.py::test_native_phase_to_mt_matches_oracle":
        "test_torch_bgv.py::test_phase_to_mt_bgv_matches",
    "test_ntt.py::test_roundtrip": f"{MN}::test_plain_ntt_matches_jax",
    "test_ntt.py::test_matches_numpy_model": f"{PH}::test_refmodel_ntts_and_psi_match_jax",
    "test_ntt.py::test_pointwise_mult_is_negacyclic_convolution":
        f"{PH}::test_refmodel_negacyclic_product_against_the_plain_ntt",
    "test_ntt.py::test_batched_shapes": f"{MN}::test_plain_ntt_matches_jax",
    "test_ntt4_dist.py::test_four_step_matches_canonical":
        "test_torch_ntt4.py::test_four_step_matches_jax_and_butterfly",
    "test_ntt4_dist.py::test_dist_ntt_sharded_matches_canonical":
        "test_torch_ntt4.py::test_distributed_ntt_bit_equal_three_ways",
    "test_ntt4_dist.py::test_dist_ntt_ring_exchange_matches_canonical":
        "test_torch_ntt4.py::test_distributed_ntt_bit_equal_three_ways",
    "test_ntt_mxu.py::test_mxu_matches_canonical":
        "test_torch_ntt_mxu.py::test_plain_matches_jax_ntt_mxu",
    "test_ntt_mxu.py::test_mxu_pallas_matches_canonical":
        "test_torch_ntt_mxu.py::test_plain_matches_pallas_interpret",
    "test_ntt_mxu.py::test_digit_bounds_exact":
        "test_torch_ntt_mxu.py::test_digit_products_exact_in_float64",
    "test_ntt_pallas.py::test_split_matches_canonical": f"{GPU}::test_ntt_kernel_matches_plain",
    "test_ntt_pallas.py::test_pallas_kernel_matches_canonical":
        f"{MN}::test_plain_ntt_matches_pallas_interpret",
    "test_ntt_pallas.py::test_pallas_kernel_single_poly_and_odd_log":
        f"{GPU}::test_ntt_kernel_every_ring_size",
    "test_parallel.py::test_sharded_batched_pie_matches_unsharded":
        "test_torch_parallel.py::test_sharded_step_bit_equal_three_ways",
    "test_parallel.py::test_sp_sharded_pie_matches_unsharded":
        "test_torch_parallel.py::test_sharded_step_bit_equal_three_ways",
    "test_parallel.py::test_sharded_simple_pie_matches_unsharded":
        "test_torch_parallel.py::test_sharded_step_bit_equal_three_ways",
    "test_parallel.py::test_pp_pipelined_pie_matches_unsharded":
        "test_torch_parallel.py::test_sharded_step_bit_equal_three_ways",
    "test_parallel.py::test_position_sum_chunked_matches_unchunked":
        "test_torch_parallel.py::test_sharded_step_bit_equal_three_ways",
    "test_parallel.py::test_sharded_pie_ring16384_shapes":
        f"{GPU}::test_sharded_steps_at_ring_16384",
    "test_parallel.py::test_sharded_pie_production_geometry_memory_bounded":
        f"{GPU}::test_sharded_step_production_geometry_memory_bounded",
    "test_pie_kernels.py::test_indexed_inner_product_matches_reference":
        "test_torch_pie_kernels.py::test_plain_matches_pallas_interpret_and_jnp",
    "test_pie_kernels.py::test_indexed_inner_product_tile_shrink":
        f"{GPU}::test_pie_kernel_shared_memory_sizes_and_persistent_grid",
    "test_protocol_e2e.py::test_batched_fhe_e2e_loopback": f"{E2E}::test_port_run_in_process",
    "test_protocol_e2e.py::test_batched_fhe_e2e_empty_intersection":
        f"{E2E}::test_port_run_in_process_empty_intersection",
    "test_protocol_e2e.py::test_batched_fhe_e2e_full_client_in_server":
        f"{E2E}::test_port_run_in_process_full_client_in_server",
    "test_protocol_e2e.py::test_batched_fhe_e2e_32bit_items": f"{E2E}::test_port_run_in_process",
    "test_protocol_e2e.py::test_batched_fhe_e2e_three_cuckoo_hfs":
        f"{E2E}::test_port_run_in_process_three_cuckoo_hfs",
    "test_protocol_e2e.py::test_batched_fhe_e2e_streamed_upload":
        f"{E2E}::test_port_run_in_process_streamed",
    "test_protocol_e2e.py::test_batched_fhe_e2e_bgv_leveled":
        f"{E2E}::test_port_bgv_and_simple_fhe_run_in_process",
    "test_protocol_e2e.py::test_batched_fhe_e2e_big_t_ring16384":
        f"{GPU}::test_protocol_at_ring_16384_default_limbs",
    "test_protocol_e2e.py::test_batched_fhe_multi_query_transaction":
        f"{E2E}::test_port_run_in_process",
    "test_simple_fhe.py::test_simple_fhe_e2e_loopback":
        f"{E2E}::test_port_bgv_and_simple_fhe_run_in_process",
    "test_simple_fhe.py::test_simple_fhe_e2e_empty": f"{E2E}::test_simple_fhe_e2e_empty",
    "test_simple_fhe.py::test_simple_fhe_bin_size_equals_table_size":
        f"{E2E}::test_simple_fhe_bin_size_equals_table_size",
    "test_simple_fhe.py::test_simple_fhe_bgv_default_limbs":
        f"{E2E}::test_simple_fhe_bgv_default_limbs",
    "test_simple_fhe.py::test_simple_fhe_bgv_default_limbs_ring16384":
        f"{GPU}::test_protocol_at_ring_16384_default_limbs",
    "test_simple_fhe.py::test_simple_fhe_e2e_40bit_ring16384":
        f"{GPU}::test_protocol_at_ring_16384_default_limbs",
    "test_simple_fhe.py::test_simple_fhe_chunked_run_matches_single_shot":
        "test_torch_simple_fhe.py::test_chunked_run_matches_single_shot",
}

# JAX test -> why no port test mirrors it
NOT_MIRRORED = {
    "test_ntt_pallas.py::test_pallas_kernel_fused_levels":
        "the Pallas kernel's fuse= option (its _fused_block butterfly grouping); K1's CUDA "
        "kernel has no such option, its radix-32 passes are held to the plain NTT at every "
        "ring size by test_torch_kernels_gpu.py::test_ntt_kernel_every_ring_size",
    "test_ntt_pallas.py::test_relabeled_domain_sandwich":
        "the Pallas kernel's relabeled= option (its exit transpose skipped, a TPU experiment "
        "measured at 1.03x); the port's K1 always returns the canonical order",
}


def test_every_jax_test_has_its_port_counterpart():
    problems = inventory_problems(_collect(port=False), set(_collect(port=True)), MIRRORS,
                                  NOT_MIRRORED)
    assert not problems, "\n".join(problems)


def test_the_walk_sees_every_jax_test_file():
    jax_tests = _collect(port=False)
    files = {t.split("::")[0] for t in jax_tests}
    assert len(files) == 33 and len(jax_tests) == 170
    assert "test_multihost.py::test_two_process_sharded_pie" in jax_tests


_JAX = ["test_a.py::test_x", "test_a.py::test_y", "test_b.py::test_z"]
_PORT = {"test_torch_a.py::test_x", "test_torch_c.py::test_w"}


@pytest.mark.parametrize("mirrors,not_mirrored,expect", [
    ({"test_a.py::test_y": "test_torch_c.py::test_w"}, {"test_b.py::test_z": "why"}, []),
    ({"test_a.py::test_y": "test_torch_c.py::test_w"}, {},
     ["test_b.py::test_z: no port test mirrors it"]),
    ({"test_a.py::test_y": "test_torch_c.py::test_gone"}, {"test_b.py::test_z": "why"},
     ["test_a.py::test_y: its mirror test_torch_c.py::test_gone does not exist"]),
    ({"test_a.py::test_x": "test_torch_c.py::test_w",
      "test_a.py::test_y": "test_torch_c.py::test_w"},
     {"test_b.py::test_z": "why"}, ["test_a.py::test_x: in MIRRORS, but"]),
    ({"test_a.py::test_y": "test_torch_c.py::test_w"},
     {"test_b.py::test_z": "why", "test_a.py::test_gone": "why"},
     ["test_a.py::test_gone: listed, but the JAX package has no such test"]),
    ({"test_a.py::test_y": "test_torch_c.py::test_w"}, {"test_b.py::test_z": ""},
     ["test_b.py::test_z: NOT_MIRRORED gives no reason"]),
    ({"test_a.py::test_y": "test_torch_c.py::test_w",
      "test_b.py::test_z": "test_torch_c.py::test_w"},
     {"test_b.py::test_z": "why"}, ["test_b.py::test_z: in both tables"]),
], ids=["complete", "unmirrored", "missing_target", "stale_same_name", "stale_gone",
        "no_reason", "both_tables"])
def test_the_walk_on_a_synthetic_pair(mirrors, not_mirrored, expect):
    got = inventory_problems(_JAX, _PORT, mirrors, not_mirrored)
    assert len(got) == len(expect) and all(g.startswith(e) for g, e in zip(got, expect)), got


def test_tests_of_reads_functions_and_test_classes():
    src = "def test_a(): pass\ndef helper(): pass\nclass TestB:\n    def test_c(self): pass\n"
    assert names_of_tests(src) == ["test_a", "TestB.test_c"]
