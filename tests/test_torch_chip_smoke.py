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


def _ptxas_report(spills, f32_spills=0):
    """A stand-in ``-Xptxas -v`` report of lstm_fwd.cu: an f32 and a
    bf16 instantiation of lstm_fwd_kernel, the bf16 one with ``spills``
    bytes stored and loaded, the f32 one with ``f32_spills``."""
    return _ptxas_lines([
        ("_ZN12_GLOBAL__N_115lstm_fwd_kernelIfLi32ELb1ELi128ELb0EEEvNS_7FwdArgsE",
         168, f32_spills),
        ("_ZN12_GLOBAL__N_115lstm_fwd_kernelI13__nv_bfloat16Li32ELb1ELi128ELb0EE"
         "EvNS_7FwdArgsE", 168, spills)])


def test_spill_gate_accepts_a_clean_bf16_lstm_fwd(capsys):
    chip_smoke._spill_gate("lstm_fwd", _ptxas_report(0))
    out = capsys.readouterr().out
    assert "bf16 lstm_fwd_kernel registers, spill bytes: [(168, 0)]" in out
    assert "f32 lstm_fwd_kernel registers, spill bytes: [(168, 0)]" in out


@pytest.mark.parametrize("spills", [8, 516])
def test_spill_gate_rejects_a_spilling_f32_lstm_fwd(spills):
    """The f32 forward is gated too (the first f32 design spilled 420 and
    676 bytes at 32 units and 128 rows)."""
    with pytest.raises(RuntimeError, match="f32 lstm_fwd_kernel spills"):
        chip_smoke._spill_gate("lstm_fwd", _ptxas_report(0, f32_spills=spills))


@pytest.mark.parametrize("spills", [8, 224])
def test_spill_gate_rejects_a_spilling_bf16_lstm_fwd(spills):
    with pytest.raises(RuntimeError, match="bf16 lstm_fwd_kernel spills"):
        chip_smoke._spill_gate("lstm_fwd", _ptxas_report(spills))


def _bwd_report(bwd_spills, dw_spills, f32_bwd_spills=0, f32_dw_spills=0):
    """A stand-in report of lstm_bwd.cu: the f32 and bf16 sweeps (a
    timed one of each too) and both lstm_dw kernels; the bf16 sweeps spill
    ``bwd_spills`` bytes, the bf16 lstm_dw ``dw_spills``, the f32 sweeps
    ``f32_bwd_spills`` and the f32 lstm_dw ``f32_dw_spills``."""
    sweep = "_ZN12_GLOBAL__N_115lstm_bwd_kernelI{}Li32ELi128ELb{}EEEvNS_7BwdArgsE"
    dw = "_ZN12_GLOBAL__N_114lstm_dw_kernelI{}EEvNS_6DwArgsE"
    bf = "13__nv_bfloat16"
    return _ptxas_lines([(sweep.format("f", 0), 200, f32_bwd_spills),
                         (sweep.format("f", 1), 204, f32_bwd_spills),
                         (sweep.format(bf, 0), 230, bwd_spills),
                         (sweep.format(bf, 1), 236, bwd_spills),
                         (dw.format("f"), 90, f32_dw_spills),
                         (dw.format(bf), 190, dw_spills)])


def test_spill_gate_accepts_clean_bf16_lstm_bwd_and_lstm_dw(capsys):
    chip_smoke._spill_gate("lstm_bwd", _bwd_report(0, 0))
    out = capsys.readouterr().out
    assert "bf16 lstm_bwd_kernel registers, spill bytes: [(230, 0), (236, 0)]" in out
    assert "bf16 lstm_dw_kernel registers, spill bytes: [(190, 0)]" in out
    assert "f32 lstm_bwd_kernel registers, spill bytes: [(200, 0), (204, 0)]" in out
    assert "f32 lstm_dw_kernel registers, spill bytes: [(90, 0)]" in out


@pytest.mark.parametrize("bwd_spills,dw_spills,kernel", [
    (8, 0, "lstm_bwd_kernel"), (0, 16, "lstm_dw_kernel")])
def test_spill_gate_rejects_a_spilling_f32_lstm_bwd_or_lstm_dw(bwd_spills, dw_spills,
                                                              kernel):
    """The f32 backward is gated too (the first f32 sweep spilled 8 bytes
    at 32 units and 128 rows)."""
    with pytest.raises(RuntimeError, match=f"f32 {kernel} spills"):
        chip_smoke._spill_gate("lstm_bwd", _bwd_report(0, 0, bwd_spills, dw_spills))


@pytest.mark.parametrize("bwd_spills,dw_spills,kernel", [
    (64, 0, "lstm_bwd_kernel"), (0, 8, "lstm_dw_kernel")])
def test_spill_gate_rejects_a_spilling_bf16_lstm_bwd_or_lstm_dw(bwd_spills, dw_spills,
                                                               kernel):
    with pytest.raises(RuntimeError, match=f"bf16 {kernel} spills"):
        chip_smoke._spill_gate("lstm_bwd", _bwd_report(bwd_spills, dw_spills))


def _fwd_report(wide_spills, wide_1024_spills=None, tf32_spills=0, tf32_1024_spills=0):
    """A stand-in report of flash_fwd.cu: the bf16 mma.sync kernel, the
    wide one at 256 and 512 (spilling ``wide_spills`` bytes) and at 1024
    in 32- and 16-row blocks (``wide_1024_spills``, by default the same),
    and the f32 3xTF32 kernel at 64, 128, 256, 512 and 1024 (the one at
    512 spilling ``tf32_spills``, the one at 1024 ``tf32_1024_spills``)."""
    ns = "_ZN12_GLOBAL__N_1"
    args = "EEvPK13__nv_bfloat16S3_S3_PS1_Pfiiiiif"
    f32_args = "EEvPKfS1_S1_PfS2_iiiiif"
    if wide_1024_spills is None:
        wide_1024_spills = wide_spills
    return _ptxas_lines([
        (f"{ns}16flash_fwd_kernelILi64ELi128{args}", 128, 0),
        (f"{ns}21flash_fwd_kernel_wideILi256ELi64{args}", 200, wide_spills),
        (f"{ns}21flash_fwd_kernel_wideILi512ELi64{args}", 210, wide_spills),
        (f"{ns}21flash_fwd_kernel_wideILi1024ELi32{args}", 220, wide_1024_spills),
        (f"{ns}21flash_fwd_kernel_wideILi1024ELi16{args}", 190, 0),
        (f"{ns}23flash_fwd_kernel_tf32x3ILi64{f32_args}", 225, 0),
        (f"{ns}23flash_fwd_kernel_tf32x3ILi128{f32_args}", 209, 0),
        (f"{ns}23flash_fwd_kernel_tf32x3ILi256{f32_args}", 212, 0),
        (f"{ns}23flash_fwd_kernel_tf32x3ILi512{f32_args}", 188, tf32_spills),
        (f"{ns}23flash_fwd_kernel_tf32x3ILi1024{f32_args}", 241, tf32_1024_spills)])


def test_spill_gate_reads_the_wide_flash_forward(capsys):
    chip_smoke._spill_gate("flash_fwd", _fwd_report(0))
    out = capsys.readouterr().out
    assert "bf16 flash_fwd_kernel registers, spill bytes: [(128, 0)]" in out
    assert ("bf16 flash_fwd_kernel_wide registers, spill bytes: "
            "[(200, 0), (210, 0), (220, 0), (190, 0)]") in out


def test_spill_gate_reads_the_tf32x3_flash_forward(capsys):
    """The f32 forward's 3xTF32 kernel is gated at every head it is built
    for, 1024 included (no SIMT forward is left)."""
    chip_smoke._spill_gate("flash_fwd", _fwd_report(0))
    out = capsys.readouterr().out
    assert ("f32 flash_fwd_kernel_tf32x3 registers, spill bytes: "
            "[(225, 0), (209, 0), (212, 0), (188, 0), (241, 0)]") in out
    assert "flash_fwd_kernel_f32 registers" not in out


@pytest.mark.parametrize("spills", [4, 640])
def test_spill_gate_rejects_a_spilling_tf32x3_flash_forward(spills):
    """One spilling instantiation of the 3xTF32 forward (the one at 512)
    fails the gate."""
    with pytest.raises(RuntimeError, match="f32 flash_fwd_kernel_tf32x3 spills"):
        chip_smoke._spill_gate("flash_fwd", _fwd_report(0, tf32_spills=spills))


@pytest.mark.parametrize("spills", [4, 256])
def test_spill_gate_rejects_a_spilling_tf32x3_flash_forward_at_1024(spills):
    """The instantiation at 1024 alone spilling fails phase 1, with the
    other heads clean."""
    with pytest.raises(RuntimeError, match=r"f32 flash_fwd_kernel_tf32x3 spills.*1024"):
        chip_smoke._spill_gate("flash_fwd", _fwd_report(0, tf32_1024_spills=spills))


def test_spill_gate_needs_the_tf32x3_flash_forward():
    """A flash_fwd.cu report without the 3xTF32 forward fails the gate."""
    lines = [ln for ln in _fwd_report(0).splitlines() if "tf32x3" not in ln]
    with pytest.raises(RuntimeError, match="f32 flash_fwd_kernel_tf32x3"):
        chip_smoke._spill_gate("flash_fwd", "\n".join(lines))


@pytest.mark.parametrize("spills", [8, 384])
def test_spill_gate_rejects_a_spilling_wide_flash_forward(spills):
    with pytest.raises(RuntimeError, match="bf16 flash_fwd_kernel_wide spills"):
        chip_smoke._spill_gate("flash_fwd", _fwd_report(spills))


@pytest.mark.parametrize("spills", [4, 512])
def test_spill_gate_rejects_a_spilling_wide_flash_forward_at_1024(spills):
    """The instantiation at 1024 alone spilling is enough to fail."""
    with pytest.raises(RuntimeError, match=r"bf16 flash_fwd_kernel_wide spills.*1024"):
        chip_smoke._spill_gate("flash_fwd", _fwd_report(0, spills))


@pytest.mark.parametrize("name,key", [
    ("void (anonymous namespace)::flash_fwd_kernel<64, 128>(Args)", "flash_fwd_kernel"),
    ("void (anonymous namespace)::flash_fwd_kernel_wide<512>(Args)", "flash_fwd_kernel"),
    ("void (anonymous namespace)::flash_fwd_kernel_f32<float, 1024, 8, 8>(Args)",
     "flash_fwd_kernel"),
    ("void (anonymous namespace)::flash_fwd_kernel_tf32x3<64>(Args)", "flash_fwd_kernel"),
    ("void (anonymous namespace)::flash_fwd_kernel_tf32x3<1024>(Args)", "flash_fwd_kernel"),
    (DKV, "flash_dkv_kernel"),
    (COPY, None)])
def test_port_kernel_reads_every_forward_kernel(name, key):
    assert chip_smoke._port_kernel(name) == key


@pytest.mark.parametrize("dtype,d,kernel", [
    ("bfloat16", 64, "flash_fwd_kernel<"), ("bfloat16", 128, "flash_fwd_kernel<"),
    ("bfloat16", 256, "flash_fwd_kernel_wide<"),
    ("bfloat16", 512, "flash_fwd_kernel_wide<"),
    ("bfloat16", 640, "flash_fwd_kernel_wide<"),
    ("bfloat16", 1024, "flash_fwd_kernel_wide<"),
    ("float32", 64, "flash_fwd_kernel_tf32x3<"), ("float32", 128, "flash_fwd_kernel_tf32x3<"),
    ("float32", 200, "flash_fwd_kernel_tf32x3<"), ("float32", 256, "flash_fwd_kernel_tf32x3<"),
    ("float32", 512, "flash_fwd_kernel_tf32x3<"), ("float32", 640, "flash_fwd_kernel_tf32x3<"),
    ("float32", 1024, "flash_fwd_kernel_tf32x3<")])
def test_fwd_kernel_name_follows_the_dispatch(dtype, d, kernel):
    assert chip_smoke.fwd_kernel_name(dtype, d) == kernel


def test_wide_head_cases_reach_1024_and_time_the_forward_at_512():
    for dtype, cases in chip_smoke.WIDE_HEAD_CASES.items():
        assert (dtype, 1024, 4, 200, 200, True) in cases
        assert {d for _, d, *_ in cases} == {256, 512, 1024}
    assert chip_smoke.WIDE_512_CASES == [("bfloat16", 512, 16, 1024, 1024, True)]
    # the d 512 timing row has the WIDE_HEAD row's bound (but for half
    # the lse bytes), set by bytes
    d, bh, t = chip_smoke.WIDE_HEAD
    ms, by = chip_smoke._flash_bound(16, 1024, 1024, 512, True, "bfloat16")
    ms_256, by_256 = chip_smoke._flash_bound(bh, t, t, d, True, "bfloat16")
    assert by == by_256 == "bytes" and ms == pytest.approx(ms_256, rel=1e-3)


def _bwd_flash_report(dq_spills, dkv_spills, tf32_dq_spills=0, tf32_dkv_spills=0,
                      wide_tf32_dq_spills=0, wide_tf32_dkv_spills=0,
                      wide_1024_dq_spills=0, wide_1024_dkv_spills=0,
                      bf16_1024_dq_spills=0, bf16_1024_dkv_spills=0):
    """A stand-in report of flash_bwd.cu: the bf16 mma.sync kernels, the
    wide ones at 256 and 512 (flash_dq_kernel_wide spilling
    ``dq_spills`` bytes, flash_dkv_kernel_wide ``dkv_spills``) and at
    1024 (flash_dq_kernel_wide<1024, 16> and <1024, 32> spilling
    ``bf16_1024_dq_spills``, flash_dkv_kernel_wide<1024>
    ``bf16_1024_dkv_spills``), the f32 3xTF32 kernels at 64 and 128
    (``tf32_dq_spills``, ``tf32_dkv_spills`` at 128), and the wide f32
    3xTF32 kernels at 256, 512 (``wide_tf32_dq_spills``,
    ``wide_tf32_dkv_spills`` at 512) and 1024 (``wide_1024_dq_spills``,
    ``wide_1024_dkv_spills``)."""
    ns = "_ZN12_GLOBAL__N_1"
    args = "EEvPK13__nv_bfloat16S3_S3_S3_S3_PKfPfPS1_iiiiiff"
    f32_args = "EEvPKfS1_S1_S1_S1_S1_PfS2_iiiiiff"
    return _ptxas_lines([
        (f"{ns}22flash_dq_kernel_tf32x3ILi64{f32_args}", 149, 0),
        (f"{ns}22flash_dq_kernel_tf32x3ILi128{f32_args}", 203, tf32_dq_spills),
        (f"{ns}23flash_dkv_kernel_tf32x3ILi64{f32_args}", 241, 0),
        (f"{ns}23flash_dkv_kernel_tf32x3ILi128{f32_args}", 254, tf32_dkv_spills),
        (f"{ns}15flash_dq_kernelILi64ELi128{args}", 125, 0),
        (f"{ns}16flash_dkv_kernelILi64ELi128{args}", 128, 0),
        (f"{ns}20flash_dq_kernel_wideILi256ELi128{args}", 243, dq_spills),
        (f"{ns}20flash_dq_kernel_wideILi512ELi64{args}", 223, dq_spills),
        (f"{ns}21flash_dkv_kernel_wideILi256{args}", 242, dkv_spills),
        (f"{ns}21flash_dkv_kernel_wideILi512{args}", 225, dkv_spills),
        (f"{ns}20flash_dq_kernel_wideILi1024ELi16{args}", 140, bf16_1024_dq_spills),
        (f"{ns}20flash_dq_kernel_wideILi1024ELi32{args}", 200, bf16_1024_dq_spills),
        (f"{ns}21flash_dkv_kernel_wideILi1024{args}", 221, bf16_1024_dkv_spills),
        (f"{ns}27flash_dq_kernel_wide_tf32x3ILi256{f32_args}", 183, 0),
        (f"{ns}27flash_dq_kernel_wide_tf32x3ILi512{f32_args}", 187, wide_tf32_dq_spills),
        (f"{ns}28flash_dkv_kernel_wide_tf32x3ILi256{f32_args[:-1]}", 254, 0),
        (f"{ns}28flash_dkv_kernel_wide_tf32x3ILi512{f32_args[:-1]}", 255,
         wide_tf32_dkv_spills),
        (f"{ns}27flash_dq_kernel_wide_tf32x3ILi1024{f32_args}", 168, wide_1024_dq_spills),
        (f"{ns}28flash_dkv_kernel_wide_tf32x3ILi1024{f32_args[:-1]}", 190,
         wide_1024_dkv_spills)])


def test_spill_gate_reads_the_wide_flash_backward(capsys):
    chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(0, 0))
    out = capsys.readouterr().out
    assert "bf16 flash_dq_kernel registers, spill bytes: [(125, 0)]" in out
    assert "bf16 flash_dkv_kernel registers, spill bytes: [(128, 0)]" in out
    # the bf16 wide kernels at 256, 512 and 1024 (dq in both tilings)
    assert ("bf16 flash_dq_kernel_wide registers, spill bytes: "
            "[(243, 0), (223, 0), (140, 0), (200, 0)]") in out
    assert ("bf16 flash_dkv_kernel_wide registers, spill bytes: "
            "[(242, 0), (225, 0), (221, 0)]") in out
    assert "f32 flash_dq_kernel_tf32x3 registers, spill bytes: [(149, 0), (203, 0)]" in out
    assert "f32 flash_dkv_kernel_tf32x3 registers, spill bytes: [(241, 0), (254, 0)]" in out
    # the bf16 gate does not read the 3xTF32 kernels
    assert "bf16 flash_dq_kernel registers, spill bytes: [(125, 0)]" in out


@pytest.mark.parametrize("dq_spills,dkv_spills,kernel", [
    (8, 0, "flash_dq_kernel_wide"), (0, 296, "flash_dkv_kernel_wide")])
def test_spill_gate_rejects_a_spilling_wide_flash_backward(dq_spills, dkv_spills,
                                                          kernel):
    with pytest.raises(RuntimeError, match=f"bf16 {kernel} spills"):
        chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(dq_spills, dkv_spills))


@pytest.mark.parametrize("tf32_dq_spills,tf32_dkv_spills,kernel", [
    (8, 0, "flash_dq_kernel_tf32x3"), (0, 132, "flash_dkv_kernel_tf32x3")])
def test_spill_gate_rejects_a_spilling_tf32x3_flash_backward(tf32_dq_spills,
                                                            tf32_dkv_spills, kernel):
    """The f32 backward's 3xTF32 kernels are gated: one instantiation
    spilling (here the one at 128) is enough to fail."""
    with pytest.raises(RuntimeError, match=f"f32 {kernel} spills"):
        chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(
            0, 0, tf32_dq_spills, tf32_dkv_spills))


def test_spill_gate_reads_the_wide_tf32x3_flash_backward(capsys):
    """The wide f32 kernels at 256, 512 and 1024 are gated under their
    own names, and the 3xTF32 gate of heads <= 128 does not read them
    (their names extend its kernels' names)."""
    chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(0, 0))
    out = capsys.readouterr().out
    assert ("f32 flash_dq_kernel_wide_tf32x3 registers, spill bytes: "
            "[(183, 0), (187, 0), (168, 0)]") in out
    assert ("f32 flash_dkv_kernel_wide_tf32x3 registers, spill bytes: "
            "[(254, 0), (255, 0), (190, 0)]") in out
    assert "f32 flash_dq_kernel_tf32x3 registers, spill bytes: [(149, 0), (203, 0)]" in out
    assert ("bf16 flash_dq_kernel_wide registers, spill bytes: "
            "[(243, 0), (223, 0), (140, 0), (200, 0)]") in out


@pytest.mark.parametrize("dq_spills,dkv_spills,kernel", [
    (4, 0, "flash_dq_kernel_wide"), (0, 64, "flash_dkv_kernel_wide")])
def test_spill_gate_rejects_a_spilling_wide_flash_backward_at_1024(dq_spills, dkv_spills,
                                                                  kernel):
    """A bf16 instantiation at 1024 alone spilling (flash_dq_kernel_wide
    <1024, 16> and <1024, 32>, flash_dkv_kernel_wide<1024>) fails phase 1,
    with the instantiation named."""
    with pytest.raises(RuntimeError, match=rf"bf16 {kernel} spills.*1024"):
        chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(
            0, 0, bf16_1024_dq_spills=dq_spills, bf16_1024_dkv_spills=dkv_spills))


@pytest.mark.parametrize("dq_spills,dkv_spills,kernel", [
    (8, 0, "flash_dq_kernel_wide_tf32x3"), (0, 24, "flash_dkv_kernel_wide_tf32x3")])
def test_spill_gate_rejects_a_spilling_wide_tf32x3_flash_backward(dq_spills, dkv_spills,
                                                                 kernel):
    """One spilling instantiation of a wide f32 kernel (the one at 512)
    fails the gate."""
    with pytest.raises(RuntimeError, match=f"f32 {kernel} spills"):
        chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(
            0, 0, wide_tf32_dq_spills=dq_spills, wide_tf32_dkv_spills=dkv_spills))


@pytest.mark.parametrize("dq_spills,dkv_spills,kernel", [
    (4, 0, "flash_dq_kernel_wide_tf32x3"), (0, 40, "flash_dkv_kernel_wide_tf32x3")])
def test_spill_gate_rejects_a_spilling_wide_tf32x3_flash_backward_at_1024(
        dq_spills, dkv_spills, kernel):
    """The instantiation at 1024 alone spilling fails phase 1, with the
    instantiation named."""
    with pytest.raises(RuntimeError, match=rf"f32 {kernel} spills.*1024"):
        chip_smoke._spill_gate("flash_bwd", _bwd_flash_report(
            0, 0, wide_1024_dq_spills=dq_spills, wide_1024_dkv_spills=dkv_spills))


def test_spill_gate_needs_the_tf32x3_kernels():
    """A flash_bwd.cu report without the 3xTF32 kernels fails the gate."""
    lines = _bwd_flash_report(0, 0).splitlines()
    with pytest.raises(RuntimeError, match="f32 flash_dq_kernel_tf32x3"):
        chip_smoke._spill_gate("flash_bwd", "\n".join(lines[16:]))


@pytest.mark.parametrize("dtype,d,names", [
    ("bfloat16", 64, ("flash_dq_kernel<", "flash_dkv_kernel<")),
    ("bfloat16", 128, ("flash_dq_kernel<", "flash_dkv_kernel<")),
    ("bfloat16", 256, ("flash_dq_kernel_wide<", "flash_dkv_kernel_wide<")),
    ("bfloat16", 512, ("flash_dq_kernel_wide<", "flash_dkv_kernel_wide<")),
    ("bfloat16", 640, ("flash_dq_kernel_wide<", "flash_dkv_kernel_wide<")),
    ("bfloat16", 1024, ("flash_dq_kernel_wide<", "flash_dkv_kernel_wide<")),
    ("float32", 64, ("flash_dq_kernel_tf32x3<", "flash_dkv_kernel_tf32x3<")),
    ("float32", 128, ("flash_dq_kernel_tf32x3<", "flash_dkv_kernel_tf32x3<")),
    ("float32", 256, ("flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<")),
    ("float32", 320, ("flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<")),
    ("float32", 512, ("flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<")),
    ("float32", 640, ("flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<")),
    ("float32", 1024, ("flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<"))])
def test_bwd_kernel_names_follow_the_dispatch(dtype, d, names):
    assert chip_smoke.bwd_kernel_names(dtype, d) == names
    # each name finds its kernel's profiled name and no other's
    assert chip_smoke._port_kernel(f"void (anonymous namespace)::{names[0]}256>(Args)") \
        == "flash_dq_kernel"
    assert chip_smoke._port_kernel(f"void (anonymous namespace)::{names[1]}256>(Args)") \
        == "flash_dkv_kernel"


def test_wide_backward_cases_reach_512_at_t1024():
    """Phase 2's backward times the wide kernels at [32, 1024, 256],
    [16, 1024, 512] and [8, 1024, 1024] causal (the same bound by
    operations: 6 d and 8 d flops per live pair), in bf16 and in f32 at
    1024, and checks them at t 200."""
    cases = chip_smoke.bwd_cases()
    d, bh, t = chip_smoke.WIDE_HEAD
    for case in [("bfloat16", d, bh, t, t, True), ("bfloat16", 512, 16, 1024, 1024, True),
                 ("bfloat16", 512, 8, 200, 200, True), ("bfloat16", 1024, 4, 200, 200, True),
                 ("bfloat16", 1024, 8, 1024, 1024, True),
                 ("float32", 1024, 8, 1024, 1024, True), ("float32", 1024, 4, 200, 200, True)]:
        assert case in cases
    assert len(set(cases)) == len(cases)
    for flops, n_out in ((6, 1), (8, 2)):
        ms_256, _ = chip_smoke._flash_bwd_bound(bh, t, t, d, True, "bfloat16",
                                                flops * d, n_out)
        for wide_bh, wide_d in ((16, 512), (8, 1024)):
            ms, _ = chip_smoke._flash_bwd_bound(wide_bh, 1024, 1024, wide_d, True,
                                                "bfloat16", flops * wide_d, n_out)
            assert ms == pytest.approx(ms_256, rel=2e-3)


def _flash_rows():
    """Stand-in phase-2 rows for the kernels line: the forward's prefill,
    training and wide rows, bf16, and its f32 rows at the f32 steps'
    shapes and at d 512, and the backward's training and wide rows, bf16
    and f32, and its f32 and bf16 rows at d 1024."""
    def fwd(bh, t, d):
        return dict(dtype="bfloat16", bh=bh, tq=t, tk=t, d=d, causal=True,
                    err_o=0.01, ms=0.1, kernel_only_ms=0.1,
                    kernel_only_ms_by_block_q={}, plain_ms=5.0, library_ms=0.05,
                    bound_ms=0.02, bound_by="bytes")

    def bwd(bh, t, d):
        return dict(dtype="bfloat16", bh=bh, tq=t, tk=t, d=d, causal=True,
                    err_dq=0.01, err_dk=0.02, err_dv=0.03, ms=0.3,
                    dq_kernel_only_ms=0.1, dkv_kernel_only_ms=0.2, plain_ms=5.0,
                    library_ms=0.2, dq_bound_ms=0.03, dq_bound_by="bytes",
                    dkv_bound_ms=0.035, dkv_bound_by="operations")

    shapes = [(chip_smoke.BATCH * chip_smoke.GPT["num_heads"], chip_smoke.PROMPT, 64),
              (chip_smoke.TRAIN_BATCH * chip_smoke.TRAIN["num_heads"], 1024, 64),
              (32, 1024, 256), (16, 1024, 512)]
    f32 = bwd(*shapes[1]) | dict(
        dtype="float32", err_dq=1e-5, err_dk=2e-5, err_dv=1.5e-5, ms=1.6,
        dq_kernel_only_ms=0.7, dkv_kernel_only_ms=0.9, plain_ms=7.3,
        library_ms=1.6, dq_bound_ms=0.385, dq_bound_by="operations",
        dkv_bound_ms=0.513, dkv_bound_by="operations",
        dq_bound_tf32x3_ms=0.156, dq_bound_tf32x3_by="operations",
        dkv_bound_tf32x3_ms=0.208, dkv_bound_tf32x3_by="operations")
    wide_f32 = f32 | dict(bh=32, d=256, err_dq=3e-6, err_dk=7e-6, err_dv=8e-6, ms=2.6,
                          dq_kernel_only_ms=1.2, dkv_kernel_only_ms=1.4, plain_ms=3.5,
                          library_ms=1.8)
    def fwd_f32(bh, t, d, ms):
        return fwd(bh, t, d) | dict(
            dtype="float32", err_o=1e-6, err_lse=2e-6, kernel_only_ms=ms, plain_ms=6.2,
            library_ms=0.63, bound_ms=0.257, bound_by="operations", bound_share=0.257 / ms,
            bound_tf32x3_ms=0.104, bound_tf32x3_by="operations",
            bound_tf32x3_share=0.104 / ms)

    return ([fwd(*s) for s in shapes]
            + [fwd_f32(*s, ms) for s, ms in zip(shapes[1:] + [(8, 1024, 1024)],
                                                (0.5, 0.55, 0.7, 0.86))]
            + [fwd(8, 1024, 1024)],
            [bwd(*s) for s in shapes[1:]] + [f32, wide_f32, wide_f32 | dict(
                bh=8, d=1024, err_dq=4e-6, err_dk=9e-6, err_dv=6e-6, ms=2.2,
                dq_kernel_only_ms=1.0, dkv_kernel_only_ms=1.2, plain_ms=9.0,
                library_ms=0.9)] + [bwd(8, 1024, 1024) | dict(
                    err_dq=0.004, err_dk=0.008, err_dv=0.016, ms=0.64,
                    dq_kernel_only_ms=0.26, dkv_kernel_only_ms=0.38, plain_ms=3.1,
                    library_ms=4.3, dq_kernel_only_ms_by_block_q={16: 0.31, 32: 0.26})])


def _phase4(train, wide_launches, f32_launches=None, wide_f32_launches=None):
    """Stand-in phase-4 result: the step's launches, the wide step's, the
    f32 step's and the wide f32 step's."""
    f32_launches = f32_launches or {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    wide_f32_launches = wide_f32_launches or {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}
    return (train, {"wide_head": {"launches": wide_launches},
                    "f32": {"launches": f32_launches},
                    "wide_f32": {"launches": wide_f32_launches}})


def test_flash_summary_names_the_wide_kernels():
    """The kernels line's flash entries carry every key of the contract;
    their wide-head entries name the wide kernels at 256, 512 and 1024
    with their bound shares and the wide training step's launches."""
    rows, bwd_rows = _flash_rows()
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    entries = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2})})
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [e["name"] for e in entries] == ["flash_fwd", "flash_dq", "flash_dkv"]
    assert all(keys <= set(e) for e in entries)
    for e, kernel in zip(entries, ("flash_fwd_kernel_wide", "flash_dq_kernel_wide",
                                   "flash_dkv_kernel_wide")):
        assert (e["wide_head"]["kernel"], e["wide_head_512"]["kernel"]) == (kernel, kernel)
        assert e["wide_head"]["shape"] == [32, 1024, 256]
        assert e["wide_head_512"]["shape"] == [16, 1024, 512]
        assert e["wide_train_launches"] == 2
    assert all(e["wide_head_1024"]["kernel"] == f"{e['name']}_kernel_wide"
               for e in entries)
    dq, dkv = entries[1], entries[2]
    assert dq["wide_head"]["bound_share"] == pytest.approx(0.3)
    assert dkv["wide_head_512"]["bound_share"] == pytest.approx(0.175)
    assert dkv["wide_head"]["max_abs_err"] == 0.03
    assert dq["wide_head_512"]["backward_ms"] == 0.3


def test_forward_only_case_times_the_wide_forward_at_1024():
    """Phase 2 times the wide forward at [8, 1024, 1024] bf16 causal (the
    other wide rows' bound by bytes: bh x d = 8192), and now the wide
    backward at 1024 with it (``WIDE_1024_CASES``, among the forward and
    the backward cases alike), as the f32 kernels there are timed
    (``WIDE_F32_1024_CASES``)."""
    assert chip_smoke.WIDE_1024_CASES == [("bfloat16", 1024, 8, 1024, 1024, True)]
    assert chip_smoke.WIDE_F32_1024_CASES == [("float32", 1024, 8, 1024, 1024, True)]
    assert not hasattr(chip_smoke, "FWD_ONLY_CASES")
    fwd, bwd = chip_smoke.fwd_cases(), chip_smoke.bwd_cases()
    assert fwd[-1:] == bwd[-1:] == chip_smoke.WIDE_1024_CASES
    assert len(set(fwd)) == len(fwd)
    assert [c for c in bwd if c[1] == 1024] == [("bfloat16", 1024, 4, 200, 200, True),
                                                ("float32", 1024, 4, 200, 200, True),
                                                ("float32", 1024, 8, 1024, 1024, True),
                                                ("bfloat16", 1024, 8, 1024, 1024, True)]
    assert chip_smoke.bwd_kernel_names("bfloat16", 1024) == (
        "flash_dq_kernel_wide<", "flash_dkv_kernel_wide<")
    ms, by = chip_smoke._flash_bound(8, 1024, 1024, 1024, True, "bfloat16")
    d, bh, t = chip_smoke.WIDE_HEAD
    ms_256, _ = chip_smoke._flash_bound(bh, t, t, d, True, "bfloat16")
    assert by == "bytes" and ms == pytest.approx(ms_256, rel=2e-3)


def test_forward_cases_keep_every_earlier_row():
    """The forward cases are the backward's (bar its prefill-length
    rows) plus the forward's own t 512 rows; the bf16 row at [8, 1024,
    1024] is in both."""
    fwd, bwd = set(chip_smoke.fwd_cases()), set(chip_smoke.bwd_cases())
    assert bwd <= fwd
    assert set(chip_smoke.WIDE_1024_CASES) <= bwd
    extra = fwd - bwd
    assert {(t, tk, bh) for _, _, bh, t, tk, _ in extra} == {(512, 512, 16)}


def test_flash_summary_gives_the_forward_its_1024_row():
    """The forward's entry carries ``wide_head_1024``: the wide kernel at
    [8, 1024, 1024], its time beside the plain version, SDPA and the
    bound."""
    rows, bwd_rows = _flash_rows()
    rows[-1] |= dict(kernel_only_ms=0.2, err_o=0.0078, library_ms=0.3,
                     plain_ms=40.0, bound_ms=0.02,
                     kernel_only_ms_by_block_q={16: 0.4, 32: 0.2})
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    fwd = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2})})[0]
    w = fwd["wide_head_1024"]
    assert w["kernel"] == "flash_fwd_kernel_wide" and w["shape"] == [8, 1024, 1024]
    assert (w["ms"], w["plain_ms"], w["library_ms"], w["max_abs_err"]) == \
        (0.2, 40.0, 0.3, 0.0078)
    assert w["bound_share"] == pytest.approx(0.1) and w["bound_by"] == "bytes"
    assert w["ms_by_block_q"] == {16: 0.4, 32: 0.2}


def test_flash_summary_gives_the_backward_its_f32_row():
    """The backward entries carry ``f32``: the 3xTF32 kernel at [128, 1024,
    64] f32 causal, its time beside the whole call, the plain version and
    SDPA, both bounds with their shares (the tensor-core one may be
    beaten by no kernel; the CUDA-core one may), and the f32 step's
    launches."""
    rows, bwd_rows = _flash_rows()
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    entries = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2},
                     {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 7})})
    fwd, dq, dkv = entries
    assert fwd["f32_train_launches"] == 8
    assert dq["f32"]["kernel"] == "flash_dq_kernel_tf32x3"
    assert dkv["f32"]["kernel"] == "flash_dkv_kernel_tf32x3"
    assert dq["f32"]["shape"] == dkv["f32"]["shape"] == [128, 1024, 64]
    assert (dq["f32"]["ms"], dq["f32"]["backward_ms"], dq["f32"]["plain_ms"],
            dq["f32"]["library_ms"]) == (0.7, 1.6, 7.3, 1.6)
    assert dq["f32"]["max_abs_err"] == 1e-5 and dkv["f32"]["max_abs_err"] == 2e-5
    assert dq["f32"]["bound_share"] == pytest.approx(0.385 / 0.7)
    assert dkv["f32"]["bound_tf32x3_share"] == pytest.approx(0.208 / 0.9)
    assert (dq["f32"]["launches"], dkv["f32"]["launches"]) == (8, 7)
    # the bf16 training row stays the entry's own
    assert dq["ms"] == 0.1 and dq["shape"] == [128, 1024, 64]


def test_flash_summary_gives_the_forward_its_f32_rows():
    """The forward's entry carries ``f32``, ``wide_head_f32`` and
    ``wide_head_f32_512``: the 3xTF32 kernel at [128, 1024, 64], [32,
    1024, 256] and [16, 1024, 512] f32 causal, its time beside the plain
    version and SDPA, both bounds with their shares, and the f32 steps'
    launches, which d 512 leaves out since no step runs f32 there; the
    bf16 rows stay the entry's own."""
    rows, bwd_rows = _flash_rows()
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    fwd = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2},
                     {"flash_fwd": 7, "flash_dq": 8, "flash_dkv": 8},
                     {"flash_fwd": 1, "flash_dq": 2, "flash_dkv": 2})})[0]
    for key, shape, ms, launches in (("f32", [128, 1024, 64], 0.5, 7),
                                     ("wide_head_f32", [32, 1024, 256], 0.55, 1),
                                     ("wide_head_f32_512", [16, 1024, 512], 0.7, None)):
        e = fwd[key]
        assert e["kernel"] == "flash_fwd_kernel_tf32x3" and e["shape"] == shape
        assert (e["ms"], e["plain_ms"], e["library_ms"]) == (ms, 6.2, 0.63)
        assert (e["max_abs_err"], e["max_abs_err_lse"]) == (1e-6, 2e-6)
        assert e["bound_share"] == pytest.approx(0.257 / ms)
        assert e["bound_tf32x3_share"] == pytest.approx(0.104 / ms)
        assert e["bound_tf32x3_by"] == "operations"
        assert e.get("launches") == launches and ("launches" in e) == (launches is not None)
    assert fwd["ms"] == 0.1 and fwd["shape"] == [64, 64, 64]


def test_flash_summary_gives_the_forward_its_f32_1024_row():
    """Phase 2's f32 case at [8, 1024, 1024] causal is among the forward
    cases and gives the forward's entry
    ``wide_head_f32_1024``: the 3xTF32 kernel's time beside the plain
    version and SDPA, both bounds with their shares, the times of both
    tilings (16 and 32 rows a block), and no launches (no step runs f32
    at 1024)."""
    case = ("float32", 1024, 8, 1024, 1024, True)
    assert case in chip_smoke.WIDE_F32_1024_CASES and case in chip_smoke.fwd_cases()
    assert chip_smoke.fwd_kernel_name("float32", 1024) == "flash_fwd_kernel_tf32x3<"
    rows, bwd_rows = _flash_rows()
    rows[-2]["kernel_only_ms_by_block_q"] = {16: 0.9, 32: 0.86}
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    fwd = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2})})[0]
    e = fwd["wide_head_f32_1024"]
    assert e["ms_by_block_q"] == {16: 0.9, 32: 0.86}
    assert e["kernel"] == "flash_fwd_kernel_tf32x3" and e["shape"] == [8, 1024, 1024]
    assert (e["ms"], e["plain_ms"], e["library_ms"]) == (0.86, 6.2, 0.63)
    assert (e["max_abs_err"], e["max_abs_err_lse"]) == (1e-6, 2e-6)
    assert e["bound_share"] == pytest.approx(0.257 / 0.86)
    assert e["bound_tf32x3_share"] == pytest.approx(0.104 / 0.86)
    assert "launches" not in e
    # the bf16 row at the same shape stays the wide kernel's
    assert fwd["wide_head_1024"]["kernel"] == "flash_fwd_kernel_wide"


def test_tf32x3_forward_bound_is_three_products_at_the_tf32_rate():
    """At [128, 1024, 64] f32 causal the forward's 4 d flops per live
    pair, three times over at 495 TFLOP/s, take 0.104 ms (operations);
    its f32 CUDA-core bound stays 0.257 ms."""
    pairs = chip_smoke._live_pairs(1024, 1024, True)
    ms, by = chip_smoke._flash_bound_tf32x3(128, 1024, 1024, 64, True)
    assert by == "operations"
    assert ms == pytest.approx(3 * 4 * 64 * 128 * pairs / 495e12 * 1e3)
    assert ms == pytest.approx(0.104, abs=1e-3)
    f32_ms, f32_by = chip_smoke._flash_bound(128, 1024, 1024, 64, True, "float32")
    assert f32_by == "operations" and f32_ms == pytest.approx(0.257, abs=1e-3)
    # a short sequence is bound by its bytes
    ms, by = chip_smoke._flash_bound_tf32x3(8, 16, 16, 512, True)
    assert by == "bytes" and ms == pytest.approx(
        (4 * 8 * 512 * 64 + 4 * 8 * 16) / 3.35e12 * 1e3)


@pytest.mark.parametrize("ratios,passes", [
    (([1.1, 0.9], [1.3, 1.0, 2.0]), True),
    (([2.2, 1.0], [1.0, 1.0, 1.0]), False),
    (([1.0, 1.0], [1.0, 6.8, 1.0]), False)])
def test_scale4_gate_holds_twice_the_reference(ratios, passes):
    """Phase 2's C3/C4 gate: a forward (o, lse) or backward (dq, dk, dv)
    error past twice the JAX package's own on the scale-4 arrays fails
    the run."""
    row = dict(d=64, forward=[1e-6, 1e-7], forward_ratio=ratios[0],
               kernels=[1e-6] * 3, ratio=ratios[1])
    if passes:
        chip_smoke.scale4_gate(row)
    else:
        with pytest.raises(RuntimeError, match="twice the reference"):
            chip_smoke.scale4_gate(row)


def test_reference_scale4_errors_cover_every_head():
    """The pinned errors of the JAX package (re-measured by
    tests/test_torch_flash_backward.py) cover each of ``SCALE4_HEADS``:
    three of the backward's, two of the forward's."""
    for table, n in ((chip_smoke.REF_SCALE4_REL, 3), (chip_smoke.REF_SCALE4_FWD_REL, 2)):
        assert sorted(table) == list(chip_smoke.SCALE4_HEADS)
        assert all(len(v) == n and all(0 < x < 1e-4 for x in v) for v in table.values())


def test_fwd_f64_is_the_dense_attention():
    """``fwd_f64`` is softmax(qs k^T) v and its log-sum-exp in f64 (the
    causal offset tk - tq), on the port's f32 pre-scale factor."""
    import torch

    rng = np.random.default_rng(3)
    q, k, v = (torch.tensor(rng.standard_normal((2, t, 8))) for t in (5, 9, 9))
    o, lse = chip_smoke.fwd_f64(torch, q, k, v, True)
    c = torch.tensor(8 ** -0.5, dtype=torch.float32).item()
    s = (q * c) @ k.transpose(1, 2)
    s = s.masked_fill(torch.ones(5, 9, dtype=torch.bool).triu(5), float("-inf"))
    assert torch.allclose(o, torch.softmax(s, -1) @ v, rtol=1e-12, atol=1e-12)
    assert torch.allclose(lse, torch.logsumexp(s, -1, keepdim=True), rtol=1e-12)
    assert o.dtype == lse.dtype == torch.float64 and lse.shape == (2, 5, 1)


def test_flash_summary_gives_the_backward_its_wide_f32_row():
    """The backward entries carry ``wide_head_f32``: the wide 3xTF32
    kernel at [32, 1024, 256] f32 causal (the wide f32 step's shape), its
    time beside the whole call, the plain version and SDPA, both bounds
    with their shares, and the wide f32 step's launches."""
    rows, bwd_rows = _flash_rows()
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    entries = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}, None,
                     {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 1})})
    fwd, dq, dkv = entries
    assert fwd["wide_f32_train_launches"] == 2
    for e, name in ((dq, "flash_dq"), (dkv, "flash_dkv")):
        w = e["wide_head_f32"]
        assert w["kernel"] == f"{name}_kernel_wide_tf32x3"
        assert w["shape"] == [32, 1024, 256]
        assert (w["backward_ms"], w["plain_ms"], w["library_ms"]) == (2.6, 3.5, 1.8)
    assert (dq["wide_head_f32"]["ms"], dkv["wide_head_f32"]["ms"]) == (1.2, 1.4)
    assert dq["wide_head_f32"]["max_abs_err"] == 3e-6
    assert dkv["wide_head_f32"]["max_abs_err"] == 8e-6
    assert dq["wide_head_f32"]["bound_share"] == pytest.approx(0.385 / 1.2)
    assert dkv["wide_head_f32"]["bound_tf32x3_share"] == pytest.approx(0.208 / 1.4)
    assert (dq["wide_head_f32"]["launches"], dkv["wide_head_f32"]["launches"]) == (2, 1)
    # the f32 row at the training shape stays the 3xTF32 kernels' of heads <= 128
    assert dq["f32"]["kernel"] == "flash_dq_kernel_tf32x3"
    assert dq["f32"]["shape"] == [128, 1024, 64]


def test_flash_summary_gives_the_backward_its_wide_f32_1024_row():
    """The backward entries carry ``wide_head_f32_1024``: the wide 3xTF32
    kernels at [8, 1024, 1024] f32 causal (``WIDE_F32_1024_CASES``), each
    one's time beside the whole call, the plain version and SDPA, both
    bounds with their shares, and no launches (no step runs f32 at
    1024)."""
    rows, bwd_rows = _flash_rows()
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    _, dq, dkv = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2})})
    for e, name, ms, err in ((dq, "flash_dq", 1.0, 4e-6), (dkv, "flash_dkv", 1.2, 9e-6)):
        w = e["wide_head_f32_1024"]
        assert w["kernel"] == f"{name}_kernel_wide_tf32x3"
        assert w["shape"] == [8, 1024, 1024]
        assert (w["ms"], w["backward_ms"], w["plain_ms"], w["library_ms"]) == \
            (ms, 2.2, 9.0, 0.9)
        assert w["max_abs_err"] == err
        assert "launches" not in w
    assert dq["wide_head_f32_1024"]["bound_share"] == pytest.approx(0.385 / 1.0)
    assert dkv["wide_head_f32_1024"]["bound_tf32x3_share"] == pytest.approx(0.208 / 1.2)
    assert dkv["wide_head_f32_1024"]["bound_ms"] == 0.513
    # the wide f32 step's row stays the one at [32, 1024, 256]
    assert dq["wide_head_f32"]["shape"] == [32, 1024, 256]


def test_flash_summary_gives_the_backward_its_1024_row():
    """The backward entries carry ``wide_head_1024``: the wide bf16
    kernels at [8, 1024, 1024] causal (``WIDE_1024_CASES``), each one's
    time beside the whole call, the plain version and SDPA, its bound and
    share, flash_dq's time at each of its tilings, and no launches (no
    step runs bf16 at 1024)."""
    rows, bwd_rows = _flash_rows()
    train = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    _, dq, dkv = chip_smoke._flash_summary({
        "2": rows, "2bwd": bwd_rows, "3": ({"flash_fwd": 8}, {}),
        "4": _phase4(train, {"flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2})})
    for e, name, ms, err, bound in ((dq, "flash_dq", 0.26, 0.004, 0.03),
                                    (dkv, "flash_dkv", 0.38, 0.016, 0.035)):
        w = e["wide_head_1024"]
        assert w["kernel"] == f"{name}_kernel_wide" and w["shape"] == [8, 1024, 1024]
        assert (w["ms"], w["backward_ms"], w["plain_ms"], w["library_ms"]) == \
            (ms, 0.64, 3.1, 4.3)
        assert w["max_abs_err"] == err
        assert w["bound_ms"] == bound and w["bound_share"] == pytest.approx(bound / ms)
        assert "launches" not in w
    assert dq["wide_head_1024"]["ms_by_block_q"] == {16: 0.31, 32: 0.26}
    assert "ms_by_block_q" not in dkv["wide_head_1024"]
    # the rows at 512 and the f32 row at 1024 stay their own
    assert dq["wide_head_512"]["shape"] == [16, 1024, 512]
    assert dq["wide_head_f32_1024"]["kernel"] == "flash_dq_kernel_wide_tf32x3"


def test_wide_f32_512_row_is_timed_at_the_wide_bound():
    """Phase 2 times the wide f32 kernels at [16, 1024, 512] causal too
    (forward and backward; the bound of [32, 1024, 256]), beside their
    rows at [32, 1024, 256] and t 200."""
    assert chip_smoke.WIDE_F32_512_CASES == [("float32", 512, 16, 1024, 1024, True)]
    fwd, bwd = chip_smoke.fwd_cases(), chip_smoke.bwd_cases()
    d, bh, t = chip_smoke.WIDE_HEAD
    for case in [("float32", 512, 16, 1024, 1024, True), ("float32", d, bh, t, t, True),
                 ("float32", 512, 8, 200, 200, True)]:
        assert case in bwd and case in fwd
    assert len(set(bwd)) == len(bwd)
    assert chip_smoke.bwd_kernel_names("float32", 512) == (
        "flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<")
    for flops, n_out in ((6, 1), (8, 2)):
        ms, _ = chip_smoke._flash_bwd_bound_tf32x3(16, 1024, 1024, 512, True,
                                                   flops * 512, n_out)
        ms_256, _ = chip_smoke._flash_bwd_bound_tf32x3(bh, t, t, d, True,
                                                       flops * d, n_out)
        assert ms == pytest.approx(ms_256, rel=2e-3)


def test_wide_f32_train_is_the_wide_step_in_f32():
    """Phase 4's wide f32 step is ``WIDE_TRAIN`` with only its dtype
    changed, at the wide step's batch: every attention call is [32,
    1024, 256] f32 causal, the timed row of phase 2, run by the wide
    3xTF32 kernels."""
    wide_f32 = dict(chip_smoke.WIDE_F32_TRAIN)
    assert wide_f32.pop("compute_dtype") == "float32"
    wide = dict(chip_smoke.WIDE_TRAIN)
    assert wide.pop("compute_dtype") == "bfloat16"
    assert wide_f32 == wide
    conf, batch, *_ = chip_smoke.F32_STEPS["train_wide_f32"]
    assert conf is chip_smoke.WIDE_F32_TRAIN and batch == chip_smoke.WIDE_TRAIN_BATCH
    heads = conf["num_heads"]
    shape = (batch * heads, conf["max_len"], conf["d_model"] // heads)
    assert shape == (32, 1024, 256)
    d, bh, t = chip_smoke.WIDE_HEAD
    assert shape == (bh, t, d)
    assert ("float32", d, bh, t, t, True) in chip_smoke.bwd_cases()
    assert chip_smoke.bwd_kernel_names("float32", shape[2]) == (
        "flash_dq_kernel_wide_tf32x3<", "flash_dkv_kernel_wide_tf32x3<")
    # the f32 step of the training width keeps its configuration
    assert chip_smoke.F32_STEPS["train_f32"][:2] == (chip_smoke.F32_TRAIN,
                                                      chip_smoke.TRAIN_BATCH)


def test_scale4_arrays_are_seeded_and_span_large_scores():
    """C3's inputs come from numpy seeds (the CPU and the card draw the
    same arrays) at every 3xTF32 head, with scores past ±40; and
    ``bwd_f64`` is the gradient of the dense f64 attention."""
    import torch

    for d in chip_smoke.SCALE4_HEADS:
        a, b = chip_smoke.scale4_arrays(np, d), chip_smoke.scale4_arrays(np, d)
        assert all(x.dtype == np.float32 and x.shape == (2, 128, d) for x in a)
        assert all(np.array_equal(x, y) for x, y in zip(a, b))
        s = a[0].astype(np.float64) / d ** 0.5 @ a[1].astype(np.float64).transpose(0, 2, 1)
        assert np.abs(s).max() > 40
    q, k, v, do = (torch.tensor(x[:, :16, :8], dtype=torch.float64, requires_grad=True)
                   for x in chip_smoke.scale4_arrays(np, 64))
    c = torch.tensor(8 ** -0.5, dtype=torch.float32).item()
    s = (q * c) @ k.transpose(1, 2)
    s = s.masked_fill(torch.ones(16, 16, dtype=torch.bool).triu(1), float("-inf"))
    (torch.softmax(s, -1) @ v).backward(do.detach())
    got = chip_smoke.bwd_f64(torch, q.detach(), k.detach(), v.detach(), do.detach(), True)
    for x, y in zip(got, (q.grad, k.grad, v.grad)):
        assert torch.allclose(x, y, rtol=1e-12, atol=1e-12)
    assert chip_smoke.rel_errors([2 * y for y in got], got) == [1.0, 1.0, 1.0]


def test_tf32x3_bound_is_three_products_at_the_tf32_rate():
    """At [128, 1024, 64] f32 causal: dq's 6 d flops per live pair, three
    times over at 495 TFLOP/s, 0.156 ms, and dkv's 8 d 0.208 ms (both
    set by operations); the f32 CUDA-core bounds stay 0.385 and 0.513."""
    pairs = chip_smoke._live_pairs(1024, 1024, True)
    assert pairs == 1024 * 1025 // 2
    for flops, n_out, tc, cuda_core in ((6 * 64, 1, 0.156, 0.385),
                                        (8 * 64, 2, 0.208, 0.513)):
        ms, by = chip_smoke._flash_bwd_bound_tf32x3(128, 1024, 1024, 64, True,
                                                     flops, n_out)
        assert by == "operations"
        assert ms == pytest.approx(3 * flops * 128 * pairs / 495e12 * 1e3)
        assert ms == pytest.approx(tc, abs=1e-3)
        f32_ms, f32_by = chip_smoke._flash_bwd_bound(128, 1024, 1024, 64, True,
                                                     "float32", flops, n_out)
        assert f32_by == "operations" and f32_ms == pytest.approx(cuda_core, abs=1e-3)


def test_f32_train_is_the_training_width_in_f32():
    """Phase 4's f32 step is ``TRAIN`` with only its dtype changed, at
    the training batch: every attention call is [128, 1024, 64] f32
    causal, the timed backward row of phase 2."""
    f32 = dict(chip_smoke.F32_TRAIN)
    assert f32.pop("compute_dtype") == "float32"
    train = dict(chip_smoke.TRAIN)
    assert train.pop("compute_dtype") == "bfloat16"
    assert f32 == train
    heads = chip_smoke.F32_TRAIN["num_heads"]
    shape = (chip_smoke.TRAIN_BATCH * heads, chip_smoke.F32_TRAIN["max_len"],
             chip_smoke.F32_TRAIN["d_model"] // heads)
    assert shape == (128, 1024, 64)
    assert ("float32", 64, 128, 1024, 1024, True) in chip_smoke.bwd_cases()
    assert chip_smoke.bwd_kernel_names("float32", shape[2]) == (
        "flash_dq_kernel_tf32x3<", "flash_dkv_kernel_tf32x3<")


def test_parent_rows_script_needs_the_card_and_no_jax():
    """``scripts/flash_fwd_rows.py`` (the parent's time at the
    bf16 rows at 1024) imports nothing of JAX and exits 2 without a
    card, printing no row."""
    _script_needs_the_card_and_no_jax("flash_fwd_rows.py", "flash_fwd ")


def test_bwd_rows_script_needs_the_card_and_no_jax():
    """``scripts/flash_bwd_rows.py`` (another checkout's backward at the
    wide rows, bf16 and f32, and its errors at scale 4) likewise."""
    _script_needs_the_card_and_no_jax("flash_bwd_rows.py", "flash_bwd ")


def test_f32_step_script_needs_the_card_and_no_jax():
    """``scripts/f32_train_step.py`` (phase 4's f32 step through another
    checkout's port) likewise."""
    _script_needs_the_card_and_no_jax("f32_train_step.py", "f32_train_step ")


def _script_needs_the_card_and_no_jax(script, line):
    import ast
    import subprocess

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    path = os.path.join(root, "scripts", script)
    with open(path) as f:
        tree = ast.parse(f.read())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module]
    assert not [m for m in names if m.split(".")[0] in ("jax", "deeplearning4j_tpu")]
    if torch.cuda.is_available():
        pytest.skip("the card is there: the script would run")
    r = subprocess.run([sys.executable, path, root], capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 2 and line not in r.stdout, r.stdout + r.stderr


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


def test_phase_breakdown_at_t1_pools_calls():
    """t = 1 (the f32 serving step): no barrier; the phases are step 0's,
    the first from the kernel's entry, pooled over calls [calls, blocks,
    1, 4]; kernel_us is the mean over calls."""
    stamps = np.zeros((2, 3, 1, 4), np.int64)
    for call in range(2):
        for blk in range(3):
            start = 100000 * call + 500 * blk
            stamps[call, blk, 0] = [start, start + 2000, start + 2500,
                                    start + 3000 + 1000 * call]
    out = chip_smoke._phase_breakdown(stamps, chip_smoke.PHASE_NAMES)
    assert out["barrier_wait_us"] is None
    assert out["chunks_but_last_us"] == pytest.approx(2.0)
    assert out["last_chunk_us"] == pytest.approx(0.5)
    assert out["cell_stores_us"] == pytest.approx(1.0)
    assert out["step_us"] == pytest.approx(3.5)
    assert (out["calls"], out["blocks"], out["steps"]) == (2, 3, 1)
    assert out["kernel_us"] == pytest.approx(4.5)


def _lstm_row(dtype, b, t, n):
    """A stand-in phase 2b row: every kernel at 1 ms, its bound 0.5."""
    names = ("lstm_fwd_only", "lstm_fwd", "lstm_bwd", "lstm_dw")
    return dict(dtype=dtype, b=b, t=t, n=n, err_fwd_only=1e-7, err_fwd=2e-7,
                err_bwd={"dg": 3e-7}, fwd_only_ms=1.0,
                fwd_only_packed_ms=0.75 if dtype == "float32" else None,
                fwd_ms=1.0, bwd_ms=1.0, dw_ms=1.0, backward_ms=2.0,
                plain_fwd_only_ms=3.0, plain_fwd_ms=3.0, plain_bwd_ms=6.0,
                library_fwd_ms=2.0, library_bwd_ms=4.0,
                bounds={k: [0.5, "bytes"] for k in names})


def test_lstm_summary_gives_every_kernel_the_lines_keys():
    """The kernels line's LSTM entries carry every key of the contract;
    ``lstm_fwd_only`` reads generate's packed time, ``lstm_fwd`` has its
    f32 entry at b 32, t 128, n 512, ``lstm_bwd`` and ``lstm_dw`` theirs
    at the char-RNN example's training shape with phase 6's f32 launches."""
    from deeplearning4j_tpu_torch.ops import lstm_kernel as lk

    rows = [_lstm_row(*case) for case in chip_smoke.LSTM_CASES]
    serve = {lk.FWD_ONLY_KERNEL: 318, lk.FWD_KERNEL: 0, lk.BWD_KERNEL: 0,
             lk.DW_KERNEL: 0}
    train = {lk.FWD_ONLY_KERNEL: 0, lk.FWD_KERNEL: 2, lk.BWD_KERNEL: 2,
             lk.DW_KERNEL: 2}
    f32_train = {lk.FWD_ONLY_KERNEL: 0, lk.FWD_KERNEL: 1, lk.BWD_KERNEL: 1,
                 lk.DW_KERNEL: 1}
    entries = chip_smoke._lstm_summary(
        {"2b": rows, "5": (serve, {}),
         "6": (train, {"f32": {"launches": f32_train}})}, lk)
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms"}
    assert [e["name"] for e in entries] == [
        lk.FWD_ONLY_KERNEL, lk.FWD_KERNEL, lk.BWD_KERNEL, lk.DW_KERNEL]
    assert all(keys <= set(e) for e in entries)
    fo, fwd = entries[0], entries[1]
    assert (fo["ms"], fo["ms_reading_wr"], fo["launches"]) == (0.75, 1.0, 318)
    assert fo["shape"] == [32, 1, 512, "float32"]
    # the f32 path is serving's: training's 2 launches are bf16
    assert fwd["f32"]["shape"] == [32, 128, 512, "float32"]
    assert (fwd["launches"], fwd["f32"]["launches"]) == (2, 0)
    assert keys - {"name", "route", "source", "replaces"} <= set(fwd["f32"])
    for bwd in entries[2:]:
        assert bwd["f32"]["shape"] == [64, 64, 256, "float32"]
        assert (bwd["launches"], bwd["f32"]["launches"]) == (2, 1)
        assert keys - {"name", "route", "source", "replaces"} <= set(bwd["f32"])
        assert bwd["f32"]["backward_ms"] == 2.0


def test_lstm_cases_hold_the_f32_example_shape():
    """Phase 2b holds the f32 backward at the char-RNN example's training
    shape, which its timer and phase 6's f32 run use too."""
    shape = (chip_smoke.EXAMPLE_BATCH, chip_smoke.EXAMPLE_SEQ,
             chip_smoke.EXAMPLE_HIDDEN)
    assert ("float32", *shape) in chip_smoke.LSTM_CASES
    assert shape in chip_smoke.F32_BWD_TIMER_CASES
    assert (32, 128, 512) in chip_smoke.F32_BWD_TIMER_CASES


def test_markov_ids_take_the_vocab():
    """The example's ids lie in its 28 characters; phase 6's bf16 run
    keeps the 64 of the benchmark's vocab."""
    rng = np.random.default_rng(0)
    ids = chip_smoke._markov_ids(np, rng, 64, 64, chip_smoke.EXAMPLE_VOCAB)
    assert ids.shape == (64, 64) and ids.min() >= 0 and ids.max() < 28
    assert chip_smoke._markov_ids(np, np.random.default_rng(1), 8, 9).max() \
        < chip_smoke.CHAR_VOCAB


def test_example_flops_per_token_counts_one_layer():
    """One GravesLSTM layer: the input and recurrent products and the head;
    the two-layer benchmark count is unchanged."""
    v, h = chip_smoke.EXAMPLE_VOCAB, chip_smoke.EXAMPLE_HIDDEN
    assert chip_smoke.char_rnn_flops_per_token(v, h, layers=1) == \
        6.0 * (v * 4 * h + h * 4 * h + h * v)
    assert chip_smoke.char_rnn_flops_per_token(64, 512) == \
        6.0 * (64 * 2048 + 3 * 512 * 2048 + 512 * 64)


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


# ------------------------------------------------- phases 7 and 8 (CPU)


def test_lenet_flops_per_example_is_the_benchmarks():
    import bench
    assert chip_smoke.lenet_train_flops_per_example() == 13.758e6
    assert chip_smoke.lenet_train_flops_per_example() == \
        bench.lenet_train_flops_per_example()


def test_lenet_conf_is_the_flagship():
    """Phase 7 rebuilds ``__graft_entry__._flagship``'s configuration
    with the port's builder, without importing that file."""
    import __graft_entry__
    want = __graft_entry__._flagship(compute_dtype="bfloat16").conf.to_json()
    assert chip_smoke._lenet_conf("bfloat16").to_json() == want


def test_mlp_iris_conf_and_batches_are_the_benchmarks():
    """``bench.py`` ``bench_mlp_iris``: the net, and its data (the 150
    rows tiled 256 times, full batches of 4096)."""
    from deeplearning4j_tpu.datasets.iris import load_iris_dataset
    from deeplearning4j_tpu.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu.nn.conf.layers import DenseLayer, OutputLayer
    want = (NeuralNetConfiguration.builder()
            .seed(3).learning_rate(0.1).updater("adam").activation("relu")
            .compute_dtype("bfloat16").list()
            .layer(DenseLayer(n_in=4, n_out=64))
            .layer(DenseLayer(n_in=64, n_out=64))
            .layer(OutputLayer(n_in=64, n_out=3, activation="softmax",
                               loss_function="mcxent"))
            .build())
    assert chip_smoke._mlp_iris_conf("bfloat16").to_json() == want.to_json()
    batches = chip_smoke.iris_batches(np)
    assert len(batches) == 256 * 150 // 4096 == 9
    iris = load_iris_dataset()
    x = np.tile(iris.features, (256, 1)).astype(np.float32)
    np.testing.assert_array_equal(batches[4].features, x[4 * 4096:5 * 4096])
    assert all(b.labels.shape == (4096, 3) for b in batches)


def test_accuracy_line_marks_synthetic_data():
    from deeplearning4j_tpu_torch.eval.evaluation import Evaluation
    ev = Evaluation()
    ev.eval(np.eye(3)[[0, 1, 2, 2]], np.eye(3)[[0, 1, 1, 2]])
    line = chip_smoke.accuracy_line("lenet evaluate", ev, 4, synthetic=True)
    assert "accuracy 0.7500" in line and "SYNTHETIC" in line
    assert "SYNTHETIC" not in chip_smoke.accuracy_line("x", ev, 4, synthetic=False)
    assert chip_smoke._rel_err([1.0, 2.0], [1.0, 4.0]) == 0.5


def _tiny_mlp(lr):
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    conf = (NeuralNetConfiguration.builder().seed(3).learning_rate(lr)
            .updater("sgd").activation("relu").list()
            .layer(L.DenseLayer(n_in=4, n_out=8))
            .layer(L.OutputLayer(n_in=8, n_out=3, activation="softmax"))
            .build())
    return MultiLayerNetwork(conf, device="cpu").init()


@pytest.mark.parametrize("lr,falls", [(0.5, True), (0.0, False)])
def test_train_metrics_gates_a_falling_loss(monkeypatch, lr, falls):
    """The steps of phases 7 and 8 on a stand-in card: metrics from the
    step times and the profile, and a refusal where the loss does not
    fall."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    monkeypatch.setattr(chip_smoke, "_device_times",
                        lambda torch, fn, reps: (fn(), {"gemm": 0.5, "relu": 0.25})[1])
    rng = np.random.default_rng(0)
    x = rng.random((32, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] * 3).astype(int)]
    batches = [DataSet(x, y)]
    net = _tiny_mlp(lr)
    if not falls:
        with pytest.raises(RuntimeError, match="loss did not fall"):
            chip_smoke._train_metrics(_fake_torch(), net, batches, 6, 100.0)
        return
    m = chip_smoke._train_metrics(_fake_torch(), net, batches, 6, 100.0)
    assert len(m["losses"]) == 6 and m["loss_last"] < m["loss_first"]
    assert m["step_device_ms"] == 0.75 and m["port_kernel_launches"] == {}
    assert m["examples_per_s"] == pytest.approx(32 / (m["step_ms"] / 1e3))
    assert m["mfu"] == pytest.approx(m["examples_per_s"] * 100.0 / 989e12)


def test_kink_free_leaves_out_an_example_on_a_relu_kink():
    """Example 0 puts a ReLU input exactly at 0 (0.5 - 0.5): its gradient
    jumps under any change of the parameters, so phase 7's gradient gate
    leaves it out; example 1 is far from every kink and stays."""
    import torch
    net = _tiny_mlp(0.1).init(torch.float64)
    W = np.zeros((4, 8))
    W[0, 0], W[1, 0] = 1.0, -1.0
    W[:, 1:] = np.random.default_rng(0).random((4, 7)) + 0.5
    net.params["layer0"]["W"] = torch.tensor(W)
    x = np.array([[0.5, 0.5, 0.0, 0.0], [1.0, 0.1, 0.0, 0.0]])
    y = np.eye(3)[[0, 1]]
    assert list(chip_smoke.kink_free(net, x, y)) == [False, True]
    assert net.params["layer0"]["W"].dtype == torch.float64  # restored


def _scan_rec(lr, n=48, batch=8):
    """A ``fit_scan_row`` run on the CPU: a tiny MLP staged and trained
    by ``best_of_fit_scan`` (2 epochs a call)."""
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    rng = np.random.default_rng(0)
    x = rng.random((n, 4)).astype(np.float32)
    y = np.eye(3, dtype=np.float32)[(x[:, 0] * 3).astype(int)]
    return chip_smoke._scan_run(_tiny_mlp(lr), DataSet(x, y), batch, 2)


@pytest.mark.parametrize("lr,want,error", [
    (0.5, {}, None), (0.0, {}, "loss did not fall"),
    (0.5, {"flash_fwd": 1}, "launched")])
def test_fit_scan_row_gates_and_keys(monkeypatch, lr, want, error):
    """A fit_scan row on a stand-in card: the step from the best timed
    call, units/s, MFU, busy share from one profiled epoch, launches per
    step; a loss that does not fall, or launches that are not the
    path's, refuse the row."""
    monkeypatch.setattr(chip_smoke, "_device_times",
                        lambda torch, fn, reps: (fn(), {"gemm": 6.0})[1])
    args = (_fake_torch(), np, kernels, "mlp", _scan_rec(lr), 8, 100.0, 989e12, want)
    if error:
        with pytest.raises(RuntimeError, match=error):
            chip_smoke.fit_scan_row(*args)
        return
    m = chip_smoke.fit_scan_row(*args)
    assert m["steps"] == 3 * 2 * 6 and m["steps_per_call"] == 12
    assert m["step_device_ms"] == 1.0  # 6 ms over the 6 staged minibatches
    assert m["units_per_s"] == pytest.approx(8 / (m["step_ms"] / 1e3))
    assert m["mfu"] == pytest.approx(m["units_per_s"] * 100.0 / 989e12)
    assert m["device_busy_share"] == pytest.approx(1.0 / m["step_ms"])
    assert m["loss_last"] < m["loss_first"]
    assert m["launches"] == m["launches_per_step"] == {}


def test_path_launches_add_the_fit_scan_and_graph_counts():
    done = {"4": (None, {"fit_scan": {"launches_per_step": {"flash_fwd": 8,
                                                            "flash_dq": 8}}}),
            "6": (None, {"fit_scan": {"launches_per_step": {"lstm_fwd": 2}}}),
            "9": {"gpt_graph": {"generate_launches": {"flash_fwd": 8}},
                  "char_rnn_graph": {"generate_launches": {"lstm_fwd_only": 318,
                                                           "lstm_fwd": 0}}}}
    entries = chip_smoke._path_launches(
        [{"name": n} for n in ("flash_fwd", "flash_dkv", "lstm_fwd",
                               "lstm_fwd_only")], done)
    got = {e["name"]: (e["fit_scan_launches_per_step"], e["graph_generate_launches"])
           for e in entries}
    assert got == {"flash_fwd": (8, 8), "flash_dkv": (0, 0), "lstm_fwd": (2, 0),
                   "lstm_fwd_only": (0, 318)}


def test_graph_phase_sizes_are_the_benchmarks():
    """Phase 9 runs ResNet-50 at the JAX package's benchmark size and the
    tiny ResNet of tests/test_zoo.py; it is a phase of the full run."""
    assert (chip_smoke.RESNET_BATCH, chip_smoke.RESNET_IMAGE,
            chip_smoke.RESNET_STEPS) == (128, 224, 8)
    assert chip_smoke.TINY_RESNET == dict(stages=(1, 1), widths=(8, 16),
                                          num_classes=4, compute_dtype="float32",
                                          learning_rate=0.01)
    assert "9" in chip_smoke.PHASES
    assert chip_smoke._phases(["--only", "4,9"]) == ("4", "9")


def test_char_rnn_graph_loads_the_networks_weights():
    """The char-RNN graph has the MultiLayerNetwork's layers, names and
    shapes, and streams as it does."""
    from deeplearning4j_tpu_torch.nn.conf import MultiLayerConfiguration
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    g = chip_smoke.char_rnn_graph(device="cpu")
    conf = (NeuralNetConfiguration.builder().seed(1).activation("tanh").list()
            .layer(L.GravesLSTM(n_in=chip_smoke.CHAR_VOCAB, n_out=chip_smoke.CHAR_HIDDEN))
            .layer(L.GravesLSTM(n_in=chip_smoke.CHAR_HIDDEN,
                                n_out=chip_smoke.CHAR_HIDDEN))
            .layer(L.RnnOutputLayer(n_in=chip_smoke.CHAR_HIDDEN,
                                    n_out=chip_smoke.CHAR_VOCAB,
                                    activation="softmax", loss_function="mcxent"))
            .build())
    net = MultiLayerNetwork(MultiLayerConfiguration.from_json(conf.to_json()),
                            device="cpu").init()
    tree = chip_smoke._random_params(net, seed=21)
    params_from_numpy(net, tree)
    params_from_numpy(g, tree)
    x = np.eye(chip_smoke.CHAR_VOCAB, dtype=np.float32)[
        np.random.default_rng(1).integers(0, chip_smoke.CHAR_VOCAB, (2, 3))]
    np.testing.assert_array_equal(g.rnn_time_step(x)[0], net.rnn_time_step(x))


def test_gpt_graph_generates_as_the_network():
    """A small ``gpt`` as the phase-9 chain: the same parameter tree, and
    the same greedy tokens on the CPU."""
    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt
    from deeplearning4j_tpu_torch.util.model_serializer import params_from_numpy

    conf = dict(vocab_size=32, d_model=32, n_layers=2, num_heads=2, max_len=32,
                compute_dtype="float32")
    net = gpt(device="cpu", **conf).init()
    g = chip_smoke.gpt_graph(conf, device="cpu")
    tree = chip_smoke._random_params(net, seed=7)
    params_from_numpy(net, tree)
    params_from_numpy(g, tree)
    prompts = np.random.default_rng(8).integers(0, 32, (2, 5))
    np.testing.assert_array_equal(g.generate(prompts, 6), net.generate(prompts, 6))


def test_layers_phase_is_the_last_and_runs_alone():
    """Phase 10 (the rest of the layer library) comes before phase 11
    (paged serving), phase 12 (the training services), phase 13 (the
    feed pipeline) and phase 14 (the serving engine), the last; each can
    be asked for alone."""
    assert chip_smoke.PHASES[-5:] == ("10", "11", "12", "13", "14")
    assert chip_smoke._phases(["--only", "10"]) == ("10",)
    assert chip_smoke._phases(["--only", "11"]) == ("11",)
    assert chip_smoke._phases(["--only", "12"]) == ("12",)
    assert chip_smoke._phases(["--only", "13"]) == ("13",)
    assert chip_smoke._phases(["--only", "14"]) == ("14",)
    assert chip_smoke.MOE_TRAIN == dict(chip_smoke.TRAIN, num_experts=8,
                                        capacity_factor=1.25,
                                        aux_loss_weight=0.01)
    assert chip_smoke.MOE_GPT == dict(chip_smoke.GPT, num_experts=8)


def test_layer_launches_add_phase_10s_paths():
    launches = {"flash_fwd": 8, "flash_dq": 8, "flash_dkv": 8}
    done = {"10": {"moe_train": {"launches": launches},
                   "moe_generate": {"launches": {"flash_fwd": 8}},
                   "quantized": {"int8": {"launches": {"flash_fwd": 8}},
                                 "fp8": {"launches": {"flash_fwd": 8}}},
                   "attention_layer": {"launches": {
                       "flash_fwd": 2, "flash_dq": 2, "flash_dkv": 2}}}}
    got = chip_smoke._layer_launches([{"name": "flash_dq"}, {"name": "lstm_bwd"}],
                                     done)
    assert got[0] == {"name": "flash_dq", "moe_train_launches_per_step": 8,
                      "moe_generate_launches": 0,
                      "quantized_generate_launches": {"int8": 0, "fp8": 0},
                      "attention_layer_launches_per_step": 2}
    assert got[1]["moe_train_launches_per_step"] == 0


def test_routing_replay_routes_by_the_recorded_experts():
    """``_routing`` records each routing call's experts and slots, and a
    replay routes by the recorded experts whatever the logits say; the
    shares count the tokens that moved."""
    import torch

    from deeplearning4j_tpu_torch.ops import moe

    rng = np.random.default_rng(0)
    x = torch.tensor(rng.standard_normal((32, 8)), dtype=torch.float32)
    w = [torch.tensor(rng.standard_normal(s), dtype=torch.float32) * 0.3
         for s in ((8, 4), (4, 8, 16), (4, 16), (4, 16, 8), (4, 8))]
    with chip_smoke._routing(torch, []) as rec:
        y, _ = moe.moe_ffn(x, *w)
    other = [w[0].flip(1)] + w[1:]  # another router: other choices
    with chip_smoke._routing(torch, [], replay=rec) as rep:
        y_r, _ = moe.moe_ffn(x, *other)
    with chip_smoke._routing(torch, []) as nat:
        moe.moe_ffn(x, *other)
    assert torch.equal(rep[0][0], rec[0][0]) and torch.equal(rep[0][1], rec[0][1])
    shares = chip_smoke._routing_shares(rec, nat)
    assert shares[0]["expert"] > 0 and shares[0]["slot"] > 0
    assert chip_smoke._routing_shares(rec, rep) == [{"expert": 0.0, "slot": 0.0}]
    assert moe.top1_route is not None and y_r.shape == y.shape


def test_layers_phase_confs_are_the_issue_widths():
    """Phase 10 (d)'s AttentionLayer stack and (e)'s DBN at MNIST's
    width, as built for the card."""
    a = chip_smoke.attention_layer_conf()
    assert [type(l).__name__ for l in a.layers] == [
        "AttentionLayer", "AttentionLayer", "RnnOutputLayer"]
    assert all(l.n_in == l.n_out == 512 and l.num_heads == 8 and l.causal
               and l.residual for l in a.layers[:2])
    assert a.conf.compute_dtype == "bfloat16"
    d = chip_smoke.dbn_conf()
    assert [(type(l).__name__, l.n_in, l.n_out) for l in d.layers] == [
        ("RBM", 784, 500), ("AutoEncoder", 500, 250), ("OutputLayer", 250, 10)]
    assert d.pretrain and d.layers[1].corruption_level == 0.3


def test_paged_launches_add_phase_11s_serve():
    done = {"11": {"launches": {"flash_fwd": 48}}}
    got = chip_smoke._paged_launches([{"name": "flash_fwd"},
                                      {"name": "lstm_bwd"}], done)
    assert got == [{"name": "flash_fwd", "paged_serve_launches": 48},
                   {"name": "lstm_bwd", "paged_serve_launches": 0}]


def test_paged_requests_and_pool_sizes():
    """Phase 11's 16 requests: prompts 16-64 from seed 8, the same every
    run; the preempting pool holds 4 full-context sequences."""
    reqs = chip_smoke._paged_requests(np)
    assert len(reqs) == chip_smoke.PAGED_REQUESTS == 16
    assert all(r.shape[0] == 1 and 16 <= r.shape[1] <= 64 for r in reqs)
    assert all((a == b).all() for a, b in
               zip(reqs, chip_smoke._paged_requests(np)))
    bs = chip_smoke.PAGED["block_size"]
    assert 4 * -(-(chip_smoke.PAGED_PROMPTS[1] + chip_smoke.NEW) // bs) \
        + 1 == 49


@pytest.fixture
def tiny_net(monkeypatch):
    import torch

    from deeplearning4j_tpu_torch.models.zoo.transformer import gpt

    monkeypatch.setattr(chip_smoke, "NEW", 6)
    torch.manual_seed(0)
    return gpt(vocab_size=64, d_model=32, n_layers=2, num_heads=2,
               max_len=64, compute_dtype="float32", device="cpu").init()


def test_eager_records_the_gaps_a_replay_reads(tiny_net):
    """``_eager``'s tokens are ``generate_eager``'s, and the gap it
    records at each generated position is the one ``_eager_gap`` reads
    by replaying the eager loop along the same tokens."""
    import torch

    from deeplearning4j_tpu_torch.nn.generate import generate_eager

    prompts = [np.random.default_rng(i).integers(0, 64, (1, 5))
               for i in range(2)]
    eager, gaps = chip_smoke._eager(torch, tiny_net, prompts)
    for p, e, g in zip(prompts, eager, gaps):
        np.testing.assert_array_equal(e, generate_eager(tiny_net, p, 6))
        assert g.shape == (6,) and (g >= 0).all()
        for j in (0, 3, 5):
            assert chip_smoke._eager_gap(torch, tiny_net, p, e[0, 5:5 + j]) \
                == pytest.approx(float(g[j]), abs=1e-6)


def test_parity_passes_near_ties_and_fails_wide_gaps(tiny_net, capsys):
    import torch

    prompts = [np.random.default_rng(i).integers(0, 64, (1, 5))
               for i in range(2)]
    eager, gaps = chip_smoke._eager(torch, tiny_net, prompts)
    assert chip_smoke._parity(torch, tiny_net, prompts, eager, eager, 0.0,
                              "same", eager, gaps) == (2, [])
    parted = [e.copy() for e in eager]
    parted[1][0, 8] = (parted[1][0, 8] + 1) % 64
    gap = float(gaps[1][3])
    whole, ties = chip_smoke._parity(torch, tiny_net, prompts, parted, eager,
                                     gap, "parted", eager, gaps)
    assert whole == 1 and ties == [dict(request=1, position=3, gap=gap)]
    assert "1 of 2 requests whole" in capsys.readouterr().out
    with pytest.raises(RuntimeError, match="top-two gap"):
        chip_smoke._parity(torch, tiny_net, prompts, parted, eager,
                           gap / 2, "parted", eager, gaps)
    # parted from a prefix that is not the eager run's: a replay reads it
    off = [p.copy() for p in parted]
    off[1][0, 9] = (off[1][0, 9] + 1) % 64
    _, ties = chip_smoke._parity(torch, tiny_net, prompts, off, parted,
                                 1e9, "replayed", eager, gaps)
    assert ties[0]["position"] == 4 and ties[0]["gap"] == pytest.approx(
        chip_smoke._eager_gap(torch, tiny_net, prompts[1],
                              parted[1][0, 5:9]), abs=1e-6)


def test_service_launches_add_phase_12s_counts():
    done = {"12": {"launches": {"lstm_fwd": 40, "lstm_fwd_only": 6},
                   "solver": {"launches": {"lstm_fwd": 11, "lstm_dw": 11}}}}
    got = chip_smoke._service_launches([{"name": "lstm_fwd"},
                                        {"name": "flash_fwd"}], done)
    assert got == [{"name": "lstm_fwd", "services_launches": 40,
                    "solver_launches": 11},
                   {"name": "flash_fwd", "services_launches": 0,
                    "solver_launches": 0}]


def test_service_runs_are_gated_bit_for_bit_where_the_step_is():
    """Phase 12 holds two runs bit for bit where two identical runs of
    the step agreed bit for bit, else within CHAR_GRAD_REL."""
    import torch
    a = {"layer0": {"W": torch.ones(3), "m": {"v": torch.zeros(2)}}}
    b = {"layer0": {"W": torch.ones(3) * (1 + 1e-3), "m": {"v": torch.zeros(2)}}}
    assert chip_smoke._tree_diff(torch, a, a) == (True, 0.0)
    same, rel = chip_smoke._tree_diff(torch, b, a)
    assert not same and rel == pytest.approx(1e-3, rel=1e-3)
    assert chip_smoke._same_run(torch, b, a, False, "w") == rel
    with pytest.raises(RuntimeError, match="bit for bit False"):
        chip_smoke._same_run(torch, b, a, True, "w")
    nan = {"layer0": {"W": torch.full((3,), float("nan")), "m": {"v": torch.zeros(2)}}}
    with pytest.raises(RuntimeError, match="inf"):
        chip_smoke._same_run(torch, nan, a, False, "w")


def test_service_batches_are_phase_6s_shape_in_uint8(monkeypatch):
    monkeypatch.setattr(chip_smoke, "CHAR_BATCH", 4)
    monkeypatch.setattr(chip_smoke, "CHAR_SEQ", 5)
    batches = chip_smoke._service_batches(np, 3, 32)
    assert len(batches) == 3
    for ds in batches:
        assert ds.features.shape == ds.labels.shape == (4, 5, chip_smoke.CHAR_VOCAB)
        assert ds.features.dtype == np.uint8 and (ds.features.sum(-1) == 1).all()
        np.testing.assert_array_equal(ds.labels.argmax(-1),
                                      np.roll(ds.features.argmax(-1), -1, axis=1))


def test_feed_launches_add_phase_13s_counts():
    done = {"13": {"launches": {"lstm_fwd": 18, "flash_dq": 32}}}
    got = chip_smoke._feed_launches([{"name": "lstm_fwd"}, {"name": "flash_dq"},
                                     {"name": "lstm_fwd_only"}], done)
    assert [e["feed_launches"] for e in got] == [18, 32, 0]


class _HostStream:
    def synchronize(self):
        pass


def test_feed_run_records_each_step_of_a_pipelined_fit():
    """Phase 13's step recorder on a CPU net (its synchronizations
    stood in for): each step's rows and labels mask, the padded tail
    through the pipeline, the snapshot before the tail, and the net's own
    step restored after."""
    import types

    import torch

    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.datasets.iterators import ListDataSetIterator
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    fake = types.SimpleNamespace(cuda=types.SimpleNamespace(
        synchronize=lambda: None, current_stream=_HostStream))
    rng = np.random.default_rng(3)
    ds = DataSet(rng.standard_normal((2 * 8 + 3, 4)).astype(np.float32),
                 np.eye(3, dtype=np.float32)[rng.integers(0, 3, 19)])
    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .updater("sgd").list().layer(L.DenseLayer(n_in=4, n_out=5))
            .layer(L.OutputLayer(n_in=5, n_out=3, activation="softmax",
                                 loss_function="mcxent")).build())
    runs = {}
    for pipeline in (False, True):
        net = MultiLayerNetwork(conf, device="cpu").init()
        steps, snap, wall = chip_smoke._feed_run(
            fake, net, ListDataSetIterator(ds, 8), pipeline, snapshot_at=2)
        assert "_fit_batch" not in net.__dict__ and wall > 0
        runs[pipeline] = steps, snap
    (off, off_snap), (on, on_snap) = runs[False], runs[True]
    assert [s["rows"] for s in off] == [8, 8, 3]
    assert [s["rows"] for s in on] == [8, 8, 8]
    assert on[-1]["labels_mask"] == [8] and off[-1]["labels_mask"] is None
    assert [s["score"] for s in on] == [s["score"] for s in off]
    assert chip_smoke._tree_diff(torch, on_snap, off_snap)[0]


def test_fractions_csv_reads_back_exactly(tmp_path):
    """Phase 13's CSV writer: every parser reads ``ints / 512`` exactly."""
    from deeplearning4j_tpu_torch import native

    ints = np.random.default_rng(4).integers(-4096, 4096, (7, 5))
    path = str(tmp_path / "q.csv")
    chip_smoke._write_fractions_csv(np, path, ints)
    want = (ints / 512).astype(np.float32)
    np.testing.assert_array_equal(np.loadtxt(path, delimiter=",",
                                             dtype=np.float32), want)
    np.testing.assert_array_equal(native.csv_read_floats(path, strict=True), want)


@pytest.mark.parametrize("warm", [False, True])
def test_event_ms_times_calls_back_to_back(warm):
    """Phases 2 and 2b time the plain versions by CUDA events: ``reps``
    calls between two events, per call, after a warm-up call if asked."""
    calls, recorded = [], []

    class Event:  # 4 calls in 10 ms
        def __init__(self, enable_timing):
            assert enable_timing

        def record(self):
            recorded.append(len(calls))

        def synchronize(self):
            pass

        def elapsed_time(self, end):
            return 10.0

    fake = _fake_torch()
    fake.cuda.Event = Event
    ms = chip_smoke._event_ms(fake, lambda: calls.append(1), 4, warm=warm)
    assert ms == pytest.approx(2.5)
    assert recorded == [int(warm), int(warm) + 4]


def test_schema_check_passes_a_traced_port_run(tmp_path):
    """The telemetry gates of phases 11 and 13 on a traced CPU fit: the
    JSONL, its Chrome trace and the registry's text pass the checker."""
    from deeplearning4j_tpu_torch import monitor
    from deeplearning4j_tpu_torch.datasets.dataset import DataSet
    from deeplearning4j_tpu_torch.nn.conf import NeuralNetConfiguration
    from deeplearning4j_tpu_torch.nn.conf import layers as L
    from deeplearning4j_tpu_torch.nn.multilayer import MultiLayerNetwork

    conf = (NeuralNetConfiguration.builder().seed(1).learning_rate(0.1)
            .updater("sgd").list()
            .layer(L.DenseLayer(n_in=4, n_out=4))
            .layer(L.OutputLayer(n_in=4, n_out=2, activation="softmax",
                                 loss_function="mcxent")).build())
    net = MultiLayerNetwork(conf, device="cpu").init()
    reg = monitor.MetricsRegistry()
    old = monitor.set_registry(reg)
    jsonl = str(tmp_path / "events.jsonl")
    tracer = monitor.enable_tracing(jsonl)
    try:
        x = np.ones((6, 4), np.float32)
        net.fit(DataSet(x, np.eye(2, dtype=np.float32)[[0, 1] * 3]))
    finally:
        monitor.disable_tracing()
        monitor.set_registry(old)
    chrome = tracer.export_chrome_trace(str(tmp_path / "trace.json"))
    chip_smoke._schema_check([jsonl, chrome], reg.prometheus_text(), str(tmp_path))
    bad = tmp_path / "bad.jsonl"
    bad.write_text('{"type": "span", "name": "x"}\n')
    with pytest.raises(RuntimeError, match="check_telemetry_schema rejected"):
        chip_smoke._schema_check([str(bad)], reg.prometheus_text(),
                                 str(tmp_path))


def test_engine_launches_add_phase_14s_counts():
    done = {"14": {"launches": {"flash_fwd": 12, "lstm_fwd_only": 64}}}
    got = chip_smoke._engine_launches(
        [{"name": "flash_fwd"}, {"name": "lstm_fwd_only"},
         {"name": "lstm_bwd"}], done)
    assert [e["engine_launches"] for e in got] == [12, 64, 0]


def test_engine_traffic_shares_one_system_prompt():
    """Phase 14 (b)'s requests: 16, each the one 48-token system prompt
    and its own 8-40-token tail, the same on every run."""
    prompts = chip_smoke._engine_traffic(np)
    assert len(prompts) == chip_smoke.ENGINE_GEN_REQUESTS == 16
    system = prompts[0][:, :chip_smoke.ENGINE_SYSTEM]
    for p in prompts:
        assert p.shape[0] == 1 and 56 <= p.shape[1] <= 88
        np.testing.assert_array_equal(p[:, :48], system)
        assert ((p >= 0) & (p < chip_smoke.GPT["vocab_size"])).all()
    again = chip_smoke._engine_traffic(np)
    assert all((a == b).all() for a, b in zip(prompts, again))
    assert max(p.shape[1] for p in prompts) + chip_smoke.ENGINE_NEW \
        <= chip_smoke.GPT["max_len"]


def test_in_threads_runs_every_call_and_reraises():
    import threading
    names = chip_smoke._in_threads(
        [lambda i=i: (i, threading.current_thread().name) for i in range(8)],
        4)
    assert [i for i, _ in names] == list(range(8))
    assert len({n for _, n in names}) == 4
    with pytest.raises(ZeroDivisionError):
        chip_smoke._in_threads([lambda: 1, lambda: 1 / 0], 2)


def test_chunks_check_contiguous_offsets():
    c = chip_smoke._Chunks()
    c(0, np.array([3]))
    c(1, np.array([4, 5]))
    assert c.tokens() == [3, 4, 5]
    c(4, np.array([6]))
    with pytest.raises(RuntimeError, match="offset 4 after 3"):
        c.tokens()


def test_tie_parity_takes_eager_runs_only_where_a_request_parts(
        monkeypatch):
    """Phase 14's parity: all requests whole reads no eager run; a
    parting one takes them and is held to the near-tie bound."""
    calls = []

    def eager(torch_, net, prompts, new=None):
        calls.append(new)
        return ([np.array([[9, 1, 2, 3]]), np.array([[9, 1, 2, 3]])],
                [np.array([0.5, 0.01, 0.5]), np.array([0.5, 0.5, 0.5])])

    monkeypatch.setattr(chip_smoke, "_eager", eager)
    prompts = [np.array([[9]]), np.array([[9]])]
    same = [np.array([[9, 1, 2, 3]]), np.array([[9, 1, 2, 3]])]
    assert chip_smoke._tie_parity(None, None, prompts, same, same, 0.05,
                                  "same", 3) == (2, [])
    assert calls == []
    parted = [np.array([[9, 1, 7, 3]]), np.array([[9, 1, 2, 3]])]
    whole, ties = chip_smoke._tie_parity(None, None, prompts, parted, same,
                                         0.05, "parted", 3)
    assert calls == [3] and whole == 1
    assert ties == [dict(request=0, position=1, gap=0.01)]
    with pytest.raises(RuntimeError, match="top-two gap is 0.5"):
        chip_smoke._tie_parity(None, None, prompts, same,
                               [np.array([[9, 4, 2, 3]])] * 2, 0.05, "wide",
                               3)
