"""PyTorch port: the kernel build report (``benchmarks/kernel_report.py``)
read from compiler output, without the CUDA toolkit.

The report parses ``nvcc -Xptxas -v`` and ``cuobjdump -sass`` text; these
tests feed it text in those tools' formats and check what it takes from
it, and that ``--require-regs`` fails a run whose warp-specialised
kernels do not get the register allotment their setmaxnreg needs.
"""

import json

import pytest

from parameter_server_tpu_torch.benchmarks import kernel_report as kr

DQ = "_ZN12_GLOBAL__N_117flash_bwd_dq_bf16ILi64EEEvNS_7TmaArgsE"
DKV = "_ZN12_GLOBAL__N_118flash_bwd_dkv_bf16ILi64EEEvNS_7TmaArgsE"

PTXAS = f"""ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '{DQ}' for 'sm_90a'
ptxas info    : Function properties for {DQ}
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 896 bytes cmem[0]
ptxas info    : Compiling entry function '{DKV}' for 'sm_90a'
ptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async instructions are serialized
ptxas info    : Function properties for {DKV}
    408 bytes stack frame, 792 bytes spill stores, 632 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 896 bytes cmem[0]
"""

SASS = f"""
	code for sm_90a
		Function : {DQ}
        /*0100*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*0110*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*0120*/              @!P0 UTMALDG.3D [UR8], [UR10] ;
        /*0130*/               @P1 SYNCS.ARRIVE.TRANS64.A1T0 RZ, [R4+URZ+0x18820], RZ ;
        /*0140*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR5+0x18840], RZ ;
		Function : {DKV}
        /*0100*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
        /*0110*/               @P0 LDL R2, [R1] ;
        /*0120*/                   STL [R1+0x4], R3 ;
"""


def test_ptxas_registers_spills_and_warnings_per_kernel():
    info = kr.parse_ptxas(PTXAS)
    assert info[DQ] == {"warnings": [], "stack": 0, "spill_stores": 0, "spill_loads": 0,
                        "registers": 168}
    assert (info[DKV]["stack"], info[DKV]["spill_stores"], info[DKV]["spill_loads"]) == (408, 792, 632)
    assert len(info[DKV]["warnings"]) == 1 and "serialized" in info[DKV]["warnings"][0]


def test_sass_counts_per_function_with_predicates():
    counts = kr.count_sass(SASS)
    assert counts[DQ] == {"HGMMA": 2, "UTMALDG": 1, "SYNCS": 2, "HMMA": 0, "LDL": 0, "STL": 0}
    assert counts[DKV] == {"HGMMA": 0, "UTMALDG": 0, "SYNCS": 0, "HMMA": 1, "LDL": 1, "STL": 1}


@pytest.mark.parametrize("registers,rc", [(168, 0), (128, 1)])
def test_require_regs_fails_a_short_allotment(monkeypatch, tmp_path, registers, rc):
    info = kr.parse_ptxas(PTXAS)
    info[DQ]["registers"] = registers
    monkeypatch.setattr(kr, "ROOT", str(tmp_path))
    monkeypatch.setattr(kr, "report", lambda name, tmp: {
        k: dict(info[k], sass=v) for k, v in kr.count_sass(SASS).items()})
    assert kr.main(["flash_bwd", "--require-regs", "flash_bwd_dq_bf16=168"]) == rc
    written = json.loads((tmp_path / "chiprun_out" / "kernel_report.json").read_text())
    assert written["flash_bwd"][DQ]["registers"] == registers
    assert written["flash_bwd"][DKV]["sass"]["LDL"] == 1
