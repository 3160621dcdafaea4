"""Protocol runners: in-process (threads + loopback channel) and TCP mains.

Counterpart of ``nested_hashing_psi_tpu.protocol.runner`` for the ported
protocols, BatchedFHE (``-F --batched``) and SimpleFHE (``-F``), each under
BFV or ``--bgv``. Both parties compute on ``device``.
The in-process loopback channel serializes every frame to bytes, as TCP
does, so what crosses it is exactly the wire format.
"""

from __future__ import annotations

import threading

from nested_hashing_psi_tpu_torch.config import HashTableParams, PSIParams
from nested_hashing_psi_tpu_torch.data.input import RandomDataInput
from nested_hashing_psi_tpu_torch.protocol.channel import LoopbackChannel, TCPChannel
from nested_hashing_psi_tpu_torch.protocol.batched_fhe import (
    BatchedFHEPSIClient,
    BatchedFHEPSIServer,
    resolve_device,
)
from nested_hashing_psi_tpu_torch.protocol.simple_fhe import (
    SimpleFHEPSIClient,
    SimpleFHEPSIServer,
)


def protocol_name(params: PSIParams) -> str:
    """Flag-driven protocol dispatch (reference ServerMain.cpp:39-62)."""
    if params.fhe:
        return "BatchedFHE" if params.batched else "SimpleFHE"
    return "PrecompElGamal" if params.precomp else "SimpleElGamal"


def make_protocol_pair(name: str):
    if name == "BatchedFHE":
        return BatchedFHEPSIClient, BatchedFHEPSIServer
    if name == "SimpleFHE":
        return SimpleFHEPSIClient, SimpleFHEPSIServer
    if name in ("SimpleElGamal", "PrecompElGamal"):
        raise NotImplementedError(f"protocol {name} is not ported yet")
    raise ValueError(f"unknown protocol {name}")


def _default_data(params: PSIParams) -> RandomDataInput:
    return RandomDataInput(
        params.server_set_size,
        params.client_set_size,
        params.intersection_set_size,
        params.item_seed,
        params.bit_size,
    )


def run_in_process(
    params: PSIParams,
    ht: HashTableParams,
    data_factory=None,
    protocol: str | None = None,
    export_dir: str = ".",
    device="cuda",
):
    """Run client+server in two threads over a loopback channel.

    ``data_factory()`` makes each party's data input (default: the seeded
    RandomDataInput of ``params``); ``protocol`` forces the pair by name
    instead of the flags' choice. Returns (client, server, ok): the client
    instance (with intersection + measurements), the server instance, and
    the client's verification.
    """
    client_cls, server_cls = make_protocol_pair(protocol or protocol_name(params))
    factory = data_factory or (lambda: _default_data(params))
    device = resolve_device(device)
    ch_client, ch_server = LoopbackChannel.pair()
    client = client_cls(factory(), params, ht, ch_client,
                        device=device, export_dir=export_dir)
    server = server_cls(factory(), params, ht, ch_server,
                        device=device, export_dir=export_dir)

    errors: list[BaseException] = []

    def server_run():
        try:
            server.run()
        except BaseException as e:  # propagate to the main thread
            errors.append(e)
            # unblock the client: its next channel read raises
            ch_server.poison()

    th = threading.Thread(target=server_run, daemon=True)
    th.start()
    try:
        ok = client.run()
    except ConnectionError:
        th.join(timeout=600)
        if errors:
            raise errors[0] from None
        raise
    th.join(timeout=600)
    if errors:
        raise errors[0]
    return client, server, ok


def run_client_tcp(params: PSIParams, ht: HashTableParams, data=None,
                   device="cuda", **kw):
    client_cls, _ = make_protocol_pair(protocol_name(params))
    device = resolve_device(device)  # fail before waiting on the network
    channel = TCPChannel.connect(params.ip, params.port)
    client = client_cls(data or _default_data(params), params, ht, channel,
                        device=device, **kw)
    ok = client.run()
    channel.close()
    return client, ok


def run_server_tcp(params: PSIParams, ht: HashTableParams, data=None,
                   device="cuda", **kw):
    _, server_cls = make_protocol_pair(protocol_name(params))
    device = resolve_device(device)
    channel = TCPChannel.listen(params.ip, params.port)
    server = server_cls(data or _default_data(params), params, ht, channel,
                        device=device, **kw)
    server.run()
    channel.close()
    return server
