"""client_decrypt_host_ms: host ms a set in the program's ``decrypt.crt``
spans (the host CRT of the downloaded phase and the decode, the client's
BGV decrypt), over the traced stretch; None under BFV, whose client
decrypts on the device."""

from psi_bench.program_spans import host_ms_per_set


def read(run):
    if run.shape.get("scheme") != "bgv":
        return None
    return host_ms_per_set(run, "decrypt.crt")
