"""Secret-material hygiene of the port (tests/test_security.py's checks).

1. The Precomp ElGamal client's random bit matrix must be unpredictable to
   the server: the online message is bits ^ one-hot(position), so a stream
   the server can regenerate reveals the client's positions. The port keys
   its AES-CTR stream from OS entropy per run, as the reference does
   (PrecompElGamalPSIClient.cpp:21-24).
2. FHE contexts that generate secret keys must be keyed from OS entropy, not
   from the wall clock.
"""

import pathlib

import numpy as np
import torch

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
from nested_hashing_psi_tpu_torch.fhe.bfv import make_context
from nested_hashing_psi_tpu_torch.fhe.params import SchemeParams
from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel
from nested_hashing_psi_tpu_torch.protocol.elgamal import PrecompElGamalPSIClient


def _fresh_precomp_client():
    params = PSIParams(server_set_size=20, client_set_size=2, intersection_set_size=1,
                       bit_size=16, curve_name="P-192", precomp=True)
    ht = HashTableParams(each_simple_table_size=4, each_cuckoo_table_size=4,
                         n_simple_hash_functions=2, n_cuckoo_hash_functions=2,
                         max_items_per_position=3)
    data = RandomDataInput(20, 2, 1, params.item_seed, params.bit_size)
    ch, _ = LoopbackChannel.pair()
    client = PrecompElGamalPSIClient(data, params, ht, ch, device="cpu")
    client.run_setup_phase()
    return client


def test_precomp_bits_are_client_private():
    """Two runs with equal shared parameters draw different bit matrices."""
    a = _fresh_precomp_client().random_bits
    b = _fresh_precomp_client().random_bits
    assert a.shape == b.shape and a.size >= 32
    assert not np.array_equal(a, b), "bit matrix is reproducible across runs"
    assert set(np.unique(a)) <= {0, 1}


def test_fhe_context_default_entropy():
    """make_context(seed=None) keys the generator from OS entropy: two
    contexts make different secret keys."""
    sp = SchemeParams(ring_dim=64, plaintext_modulus=257, num_limbs=2)
    s1, _ = make_context(sp, seed=None, device="cpu").keygen()
    s2, _ = make_context(sp, seed=None, device="cpu").keygen()
    assert not torch.equal(s1.s_ntt, s2.s_ntt)


def test_no_wallclock_key_seeds():
    """No module of the port seeds a context or a generator from time."""
    root = pathlib.Path(__file__).resolve().parents[1] / "nested_hashing_psi_tpu_torch"
    files = list(root.rglob("*.py"))
    assert len(files) > 30
    for f in files:
        src = f.read_text()
        assert "time.time_ns() % 2**31" not in src, f"weak key seed in {f}"
        assert "seed=time" not in src and "seed=int(time" not in src, f"clock seed in {f}"
