"""``chip_smoke._device_times`` on a stand-in profiler: the port's
kernels are read by their launch counts however many of their events the
profile kept, and a profile that kept none of a kernel that ran is taken
again. (The script itself needs the card; these parts run anywhere.)"""

import os
import sys
import types

import pytest
import torch.profiler

from deeplearning4j_tpu_torch import kernels

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import chip_smoke  # noqa: E402

DQ = "void flash::flash_dq_kernel<64, 128>(Args)"
DKV = "void flash::flash_dkv_kernel<64, 128>(Args)"
COPY = "Memcpy DtoD (Device -> Device)"


def _fake_torch():
    cuda = types.SimpleNamespace(synchronize=lambda: None)
    return types.SimpleNamespace(cuda=cuda)


def _profiles(monkeypatch, kept):
    """Stand in for torch.profiler: the n-th profile taken keeps
    ``kept[n]``, a list of (name, events kept, device us per event)."""
    taken = []

    class Profile:
        def __init__(self, activities):
            self.kept = kept[len(taken)]
            taken.append(self)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

        def key_averages(self):
            return [types.SimpleNamespace(key=name, count=n,
                                          self_device_time_total=n * us)
                    for name, n, us in self.kept]

        def events(self):
            return self.key_averages()

    monkeypatch.setattr(torch.profiler, "profile", Profile)
    monkeypatch.setattr(chip_smoke, "PROFILE_PADS", (0.0, 0.0, 0.0))
    return taken


def _backward_call():
    kernels.LAUNCHES["flash_dq"] += 1
    kernels.LAUNCHES["flash_dkv"] += 1


@pytest.fixture(autouse=True)
def _fresh_launches():
    kernels.reset_launches()
    yield
    kernels.reset_launches()


@pytest.mark.parametrize("kept_dq", [10, 3, 1])
def test_port_kernels_read_by_their_launches(monkeypatch, kept_dq):
    taken = _profiles(monkeypatch, [[(DQ, kept_dq, 110.0), (DKV, 10, 170.0),
                                     (COPY, 10, 2.0)]])
    times = chip_smoke._device_times(_fake_torch(), _backward_call, 10)
    assert len(taken) == 1
    assert times[DQ] == pytest.approx(0.110)
    assert times[DKV] == pytest.approx(0.170)
    assert times[COPY] == pytest.approx(0.002)
    assert times.kept_share == pytest.approx((kept_dq + 10) / 20)
    assert chip_smoke._sum_ms(times, "flash_dq_kernel") == pytest.approx(0.110)


@pytest.mark.parametrize("missed", [[(DKV, 4, 170.0)], []])
def test_profile_that_missed_a_port_kernel_is_taken_again(monkeypatch,
                                                          missed):
    taken = _profiles(monkeypatch, [missed, [(DQ, 2, 110.0), (DKV, 7, 170.0)]])
    times = chip_smoke._device_times(_fake_torch(), _backward_call, 10)
    assert len(taken) == 2
    assert chip_smoke._sum_ms(times, "flash_dq_kernel") == pytest.approx(0.110)
    assert chip_smoke._sum_ms(times, "flash_dkv_kernel") == pytest.approx(0.170)


def test_no_whole_profile_falls_back_to_event_time(monkeypatch):
    taken = _profiles(monkeypatch, [[(DKV, 4, 170.0)]] * 3)

    class Event:  # 10 calls in 2.5 ms
        def __init__(self, enable_timing):
            pass

        def record(self):
            pass

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 2.5

    fake = _fake_torch()
    fake.cuda.Event = Event
    times = chip_smoke._device_times(fake, _backward_call, 10)
    assert len(taken) == 3
    assert times == {chip_smoke.EVENT_TIMED: pytest.approx(0.25)}
    with pytest.raises(RuntimeError, match="flash_dq_kernel"):
        chip_smoke._sum_ms(times, "flash_dq_kernel")
