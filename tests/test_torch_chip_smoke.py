"""Parts of ``chip_smoke.py`` on stand-ins. ``_device_times`` on a
stand-in profiler: the port's kernels are read by their launch counts
however many of their events the profile kept, and a profile that kept
none of a kernel that ran is taken again. Phase 1's spill gate on a
stand-in ptxas report, the LSTM step timer's summary on stand-in
stamps, and phase 6's gradient comparison on small CPU gradients. (The
script itself needs the card; these parts run anywhere.)"""

import os
import sys
import types

import numpy as np
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


def _ptxas_lines(entries):
    """``-Xptxas -v`` report lines for (mangled name, registers, spill
    bytes stored and loaded)."""
    lines = []
    for name, regs, sp in entries:
        lines += [f"ptxas info    : Compiling entry function '{name}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {name}",
                  f"    {sp} bytes stack frame, {sp // 2} bytes spill stores, "
                  f"{sp - sp // 2} bytes spill loads",
                  f"ptxas info    : Used {regs} registers, used 1 barriers"]
    return "\n".join(lines)


def _ptxas_report(spills):
    """A stand-in ``-Xptxas -v`` report of lstm_fwd.cu: an f32 and a
    bf16 instantiation of lstm_fwd_kernel, the bf16 one with ``spills``
    bytes stored and loaded."""
    return _ptxas_lines([
        ("_ZN12_GLOBAL__N_115lstm_fwd_kernelIfLi32ELb1ELi128ELb0EEEvNS_7FwdArgsE",
         255, 516),
        ("_ZN12_GLOBAL__N_115lstm_fwd_kernelI13__nv_bfloat16Li32ELb1ELi128ELb0EE"
         "EvNS_7FwdArgsE", 168, spills)])


def test_spill_gate_accepts_a_clean_bf16_lstm_fwd(capsys):
    chip_smoke._spill_gate("lstm_fwd", _ptxas_report(0))
    assert "bf16 lstm_fwd_kernel registers, spill bytes: [(168, 0)]" in \
        capsys.readouterr().out


@pytest.mark.parametrize("spills", [8, 224])
def test_spill_gate_rejects_a_spilling_bf16_lstm_fwd(spills):
    with pytest.raises(RuntimeError, match="bf16 lstm_fwd_kernel spills"):
        chip_smoke._spill_gate("lstm_fwd", _ptxas_report(spills))


def _bwd_report(bwd_spills, dw_spills):
    """A stand-in report of lstm_bwd.cu: the f32 and bf16 sweeps (a
    timed bf16 one too) and both lstm_dw kernels; the bf16 sweeps spill
    ``bwd_spills`` bytes, the bf16 lstm_dw ``dw_spills``."""
    sweep = "_ZN12_GLOBAL__N_115lstm_bwd_kernelI{}Li32ELi128ELb{}EEEvNS_7BwdArgsE"
    dw = "_ZN12_GLOBAL__N_114lstm_dw_kernelI{}EEvNS_6DwArgsE"
    bf = "13__nv_bfloat16"
    return _ptxas_lines([(sweep.format("f", 0), 200, 96),
                         (sweep.format(bf, 0), 230, bwd_spills),
                         (sweep.format(bf, 1), 236, bwd_spills),
                         (dw.format("f"), 90, 0), (dw.format(bf), 190, dw_spills)])


def test_spill_gate_accepts_clean_bf16_lstm_bwd_and_lstm_dw(capsys):
    chip_smoke._spill_gate("lstm_bwd", _bwd_report(0, 0))
    out = capsys.readouterr().out
    assert "bf16 lstm_bwd_kernel registers, spill bytes: [(230, 0), (236, 0)]" in out
    assert "bf16 lstm_dw_kernel registers, spill bytes: [(190, 0)]" in out


@pytest.mark.parametrize("bwd_spills,dw_spills,kernel", [
    (64, 0, "lstm_bwd_kernel"), (0, 8, "lstm_dw_kernel")])
def test_spill_gate_rejects_a_spilling_bf16_lstm_bwd_or_lstm_dw(bwd_spills, dw_spills,
                                                               kernel):
    with pytest.raises(RuntimeError, match=f"bf16 {kernel} spills"):
        chip_smoke._spill_gate("lstm_bwd", _bwd_report(bwd_spills, dw_spills))


def test_spill_gate_needs_a_bf16_instantiation():
    report = "\n".join(_ptxas_report(0).splitlines()[:4])  # the f32 one only
    with pytest.raises(RuntimeError, match="bf16 lstm_fwd_kernel"):
        chip_smoke._spill_gate("lstm_fwd", report)


def test_phase_breakdown_means_over_blocks_and_steps():
    """Two blocks, three steps; block 1 runs 1 us behind block 0. The
    means leave out step 0, which has no barrier before it."""
    # per step: barrier 2 (steps 1, 2), chunks but the last 3, the last
    # chunk 4 (or 6 in block 1), cell + stores 1
    stamps = np.zeros((2, 3, 4), np.int64)
    for blk, product in ((0, 4000), (1, 6000)):
        end = 1000 * blk
        for s in range(3):
            start = end + (2000 if s else 0)
            stamps[blk, s] = [start, start + 3000, start + 3000 + product,
                              start + 4000 + product]
            end = stamps[blk, s, 3]
    out = chip_smoke._phase_breakdown(stamps, chip_smoke.PHASE_NAMES)
    assert out["barrier_wait_us"] == pytest.approx(2.0)
    assert out["chunks_but_last_us"] == pytest.approx(3.0)
    assert out["last_chunk_us"] == pytest.approx(5.0)
    assert out["cell_stores_us"] == pytest.approx(1.0)
    assert out["step_us"] == pytest.approx(11.0)
    assert out["step_us"] == pytest.approx(sum(
        out[f"{k}_us"] for k in chip_smoke.PHASE_NAMES))
    assert (out["blocks"], out["steps"]) == (2, 3)
    assert out["kernel_us"] == pytest.approx((stamps[1, 2, 3] - 0) / 1e3)


def test_phase_breakdown_names_the_sweeps_phases():
    """The backward sweep's stamps under its own names: one block, four
    steps of 1 us barrier, 6 us of dg chunks, 2 us of the last chunk's
    product and 3 us of the gate chain."""
    stamps = np.zeros((1, 4, 4), np.int64)
    for s in range(4):
        start = 12000 * s
        stamps[0, s] = [start, start + 6000, start + 8000, start + 11000]
    out = chip_smoke._phase_breakdown(stamps, chip_smoke.BWD_PHASE_NAMES)
    assert set(out) >= {f"{k}_us" for k in chip_smoke.BWD_PHASE_NAMES}
    assert "cell_stores_us" not in out
    assert out["barrier_wait_us"] == pytest.approx(1.0)
    assert out["chunks_but_last_us"] == pytest.approx(6.0)
    assert out["last_chunk_us"] == pytest.approx(2.0)
    assert out["chain_stores_us"] == pytest.approx(3.0)
    assert out["step_us"] == pytest.approx(12.0)
    assert out["timer_tick_ns"] == 1000


def test_phase_breakdown_refuses_stamps_out_of_order():
    stamps = np.zeros((1, 2, 4), np.int64)
    stamps[0] = [[0, 1, 2, 3], [10, 9, 12, 13]]
    with pytest.raises(RuntimeError, match="not in order"):
        chip_smoke._phase_breakdown(stamps, chip_smoke.PHASE_NAMES)


def _grads(scale, bad=None):
    """Two layers' stand-in gradients, each times ``scale``; ``bad``
    replaces one entry of layer1/W."""
    g = torch.Generator().manual_seed(3)
    grads = {layer: {name: torch.randn(8, 4, generator=g) for name in ("W", "b")}
             for layer in ("layer0", "layer1")}
    out = {layer: {name: x * scale for name, x in gl.items()}
           for layer, gl in grads.items()}
    if bad is not None:
        out["layer1"]["W"][2, 1] = bad
    return out


def test_grads_vs_plain_reads_the_worst_layer():
    assert chip_smoke._grads_vs_plain(torch, "t", _grads(1.01), _grads(1.0)) \
        == pytest.approx(0.01, rel=1e-4)


@pytest.mark.parametrize("scale,bad,match", [
    (1.0 + 2 * chip_smoke.CHAR_GRAD_REL, None, "rel L2"),
    (1.0, float("nan"), "finite grad layer1/W"),
    (1.0, float("inf"), "finite grad layer1/W")])
def test_grads_vs_plain_refuses(scale, bad, match):
    with pytest.raises(RuntimeError, match=match):
        chip_smoke._grads_vs_plain(torch, "t", _grads(scale, bad), _grads(1.0))


def test_grad_rel_names_the_worst_gradient():
    got = _grads(1.0)
    got["layer0"]["b"] = got["layer0"]["b"] * 1.05
    worst, at = chip_smoke._grad_rel(torch, got, _grads(1.0))
    assert worst == pytest.approx(0.05, rel=1e-4) and at == "layer0/b"
    worst, at = chip_smoke._grad_rel(torch, _grads(1.0, float("nan")), _grads(1.0))
    assert worst == float("inf") and at == "layer1/W"
