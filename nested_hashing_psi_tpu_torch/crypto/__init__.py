"""Host-side ElGamal/EC backend (reference: libscapi DlogGroup + OpenSSL EC;
SURVEY.md section 2.2 keeps it on the host in both packages -- no GPU kernel
runs on the ElGamal path). The port's own copy of
``nested_hashing_psi_tpu.crypto``, with the same exports."""

from nested_hashing_psi_tpu_torch.crypto.ec import EcGroup, CURVES, ec_group  # noqa: F401
from nested_hashing_psi_tpu_torch.crypto.ec2m import BinaryEcGroup, BINARY_CURVES  # noqa: F401
from nested_hashing_psi_tpu_torch.crypto.elgamal import AddHomElGamal, ElGamalCiphertext  # noqa: F401
