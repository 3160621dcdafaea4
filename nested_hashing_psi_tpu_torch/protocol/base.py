"""Abstract 3-phase PSI client/server orchestration.

The port's own copy of ``nested_hashing_psi_tpu.protocol.base``,
with the same names and behaviour: the port imports nothing of the JAX
package. tests/test_torch_host_modules.py holds it against the original.

Capability parity with the reference's PSIClient/PSIServer
(reference src/Client/PSIClient.hpp:72-205, src/Server/PSIServer.hpp:66-104):
setup -> offline -> online with end-of-phase barriers, per-phase wall-clock +
bytes in/out measurement, self-verifying client (computed intersection vs the
generator's ground truth), and the same CSV export schema
({Setup,Offline,Online} x {Time us, BytesIn, BytesOut}).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from datetime import date
from pathlib import Path

import numpy as np

from nested_hashing_psi_tpu_torch.config import PSIParams
from nested_hashing_psi_tpu_torch.data.input import DataInputHandler
from nested_hashing_psi_tpu_torch.protocol.channel import Channel

PHASE_SIGNAL_BYTES = 8  # empty message = 8-byte length prefix


@dataclass
class PSIMeasurement:
    duration_us: int
    bytes_in: int
    bytes_out: int


class PSIClientBase:
    def __init__(
        self,
        data: DataInputHandler,
        params: PSIParams,
        channel: Channel,
        protocol_name: str,
        export_dir: str = ".",
    ):
        self.data = data
        self.params = params
        self.channel = channel
        self.protocol_name = protocol_name
        self.client_set = data.get_client_set()
        self.intersection_calculated = np.zeros((0, 2), dtype=np.uint64)
        self.measurements: dict[str, PSIMeasurement] = {}
        self.export_path = Path(export_dir) / (
            f"MClient_CS_{params.client_set_size}_SS_{params.server_set_size}"
            f"_P_{protocol_name}_T_{params.number_of_threads}_{date.today()}.csv"
        )

    # phase hooks
    def run_setup_phase(self) -> None:
        raise NotImplementedError

    def run_offline_phase(self) -> None:
        raise NotImplementedError

    def run_online_phase(self) -> None:
        raise NotImplementedError

    def _read_phase_over(self) -> None:
        self.channel.read_msg()

    def run(self) -> bool:
        for phase_name, fn, barrier in (
            ("Setup", self.run_setup_phase, True),
            ("Offline", self.run_offline_phase, True),
            ("Online", self.run_online_phase, False),
        ):
            begin = time.monotonic_ns()
            fn()
            if barrier:
                self._read_phase_over()
            dur_us = (time.monotonic_ns() - begin) // 1000
            self.measurements[phase_name] = PSIMeasurement(
                dur_us, self.channel.bytes_in, self.channel.bytes_out
            )
            self.channel.reset_counters()
            if self.params.verbose:
                print(f"{phase_name} time = {dur_us}[us]")

        matches = self.intersection_matches()
        if matches:
            print("Set matches!")
            if self.params.export_performance:
                self.export_measurements()
        else:
            print("Error calculated set does not match!")
        return matches

    def intersection_matches(self) -> bool:
        expected = {tuple(r) for r in self.data.get_intersection_set().tolist()}
        got = {tuple(r) for r in self.intersection_calculated.tolist()}
        return expected == got

    def export_measurements(self) -> None:
        with open(self.export_path, "a") as f:
            for phase in ("Setup", "Offline", "Online"):
                m = self.measurements[phase]
                bytes_in = m.bytes_in
                if phase in ("Setup", "Offline"):
                    bytes_in -= PHASE_SIGNAL_BYTES
                f.write(f"{phase}Time,{m.duration_us}\n")
                f.write(f"{phase}BytesIn,{bytes_in}\n")
                f.write(f"{phase}BytesOut,{m.bytes_out}\n")


class PSIServerBase:
    def __init__(
        self,
        data: DataInputHandler,
        params: PSIParams,
        channel: Channel,
        protocol_name: str,
        export_dir: str = ".",
    ):
        self.data = data
        self.params = params
        self.channel = channel
        self.protocol_name = protocol_name
        self.server_set = data.get_server_set()
        self.offline_computation_us = 0
        self.online_computation_us = 0
        self.export_path = Path(export_dir) / (
            f"MServer_CS_{params.client_set_size}_SS_{params.server_set_size}"
            f"_P_{protocol_name}_T_{params.number_of_threads}_{date.today()}.csv"
        )

    def run_setup_phase(self) -> None:
        raise NotImplementedError

    def run_offline_phase(self) -> None:
        raise NotImplementedError

    def run_online_phase(self) -> None:
        raise NotImplementedError

    def _signal_phase_over(self) -> None:
        self.channel.write_msg(b"")

    def run(self) -> None:
        self.run_setup_phase()
        self._signal_phase_over()
        self.run_offline_phase()
        self._signal_phase_over()
        self.run_online_phase()

    def export_measurements(self) -> None:
        with open(self.export_path, "a") as f:
            f.write(f"OfflineComputationTime,{self.offline_computation_us}\n")
            f.write(f"OnlineComputationTime,{self.online_computation_us}\n")
