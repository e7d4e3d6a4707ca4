"""The board's energy counter and power limit through NVML
(``libnvidia-ml.so.1`` with ctypes; after ``launch/serve.py``'s ``_Nvml``).
``energy_mj()`` is ``nvmlDeviceGetTotalEnergyConsumption``, a running
total in millijoules of the card behind the CUDA device, matched by its
PCI bus id. The counter is coarse over tens of milliseconds, so it is read
over a whole window."""
from __future__ import annotations

import ctypes

import torch


class Nvml:
    def __init__(self, device: torch.device):
        self.lib = ctypes.CDLL("libnvidia-ml.so.1")
        self._call("nvmlInit_v2")
        props = torch.cuda.get_device_properties(device)
        self.handle = ctypes.c_void_p()
        if hasattr(props, "pci_bus_id"):
            bus = (f"{props.pci_domain_id:08x}:{props.pci_bus_id:02x}:"
                   f"{props.pci_device_id:02x}.0").encode()
            self._call("nvmlDeviceGetHandleByPciBusId_v2",
                       ctypes.c_char_p(bus), ctypes.byref(self.handle))
        else:
            index = 0 if device.index is None else device.index
            self._call("nvmlDeviceGetHandleByIndex_v2", ctypes.c_uint(index),
                       ctypes.byref(self.handle))

    def _call(self, name: str, *args) -> None:
        rc = getattr(self.lib, name)(*args)
        if rc != 0:
            raise RuntimeError(f"NVML {name} failed with code {rc}")

    def energy_mj(self) -> int:
        e = ctypes.c_ulonglong()
        self._call("nvmlDeviceGetTotalEnergyConsumption", self.handle,
                   ctypes.byref(e))
        return int(e.value)

    def power_limit_w(self) -> float:
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetEnforcedPowerLimit", self.handle,
                   ctypes.byref(mw))
        return mw.value / 1e3

    def close(self) -> None:
        self.lib.nvmlShutdown()
