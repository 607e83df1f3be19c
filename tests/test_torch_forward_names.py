"""The attention kernels' names, build records and checks on the CPU.

Each attention kernel has two bodies (bf16 on the tensor cores, fp32 FMA
loops) under one name, ``attn_fwd_kernel<T, mode, route, D, variant>``,
``attn_bwd_dq_kernel<T, mode, route, D>`` and ``attn_bwd_dkv_kernel<...>``,
so that a profile of this version and of the versions before it map to the
same launch counts (``flash_attention.launch_key``) and timing kinds
(``kernel_timing._kernel_kind``). ``chip_smoke.py`` reads the build's
``-Xptxas -v`` log and the library's ``cuobjdump -sass`` listing to show
which units each instantiation runs on; the parsers are checked here on
sample text. The bf16 forward's TMA tensor maps need 16-byte aligned
operands, which the wrapper's checks enforce on any device. The smoke and
the card tests hold a bf16 forward row by row (``chip_smoke.row_error``);
that check is shown here to fail a fault the global limit passes.
"""

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ptxas_report
from reprover_tpu_torch.ops import flash_attention as tfa
from reprover_tpu_torch.ops import kernel_timing
from reprover_tpu_torch.utils.misc import cap_cpu_threads

cap_cpu_threads()

ROUTE_KIND = {tfa.FULL_ROW: "fwd", tfa.LONG: "long", tfa.LONG_LSE: "long_lse"}
MODE_PREFIX = {tfa.ENCODER: "", tfa.CAUSAL: "causal_", tfa.CROSS: "cross_",
               tfa.SCALED_CAUSAL: "scaled_causal_"}
INSTANCES = [(mode, route, d) for mode, route in itertools.product(tfa.KERNEL_NAMES, ROUTE_KIND)
             for d in tfa.HEAD_DIMS[mode]]

PARENT_ARGS = ("(__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, int const*, "
               "float const*, int const*, __nv_bfloat16*, float*, int, int, int, int)")
MAPS = "CUtensorMap_st, CUtensorMap_st, CUtensorMap_st, "


def _names(mode: int, route: int, d: int, variant: int = 0) -> dict:
    """Profiled names of one forward instantiation: the parent version's
    bf16 kernel, this version's bf16 (tensor-core) and fp32 (FMA) bodies,
    and the bare form some profiles print."""
    args = f"{mode}, {route}, {d}, {variant}"
    return {
        "parent_bf16": f"void (anonymous namespace)::attn_fwd_kernel<__nv_bfloat16, {args}>"
                       + PARENT_ARGS,
        "bf16": f"void (anonymous namespace)::attn_fwd_kernel<__nv_bfloat16, {args}>("
                + MAPS + "__nv_bfloat16 const*, __nv_bfloat16 const*, __nv_bfloat16 const*, "
                "int const*, float const*, int const*, __nv_bfloat16*, float*, int, int, int, int)",
        "fp32": f"void (anonymous namespace)::attn_fwd_kernel<float, {args}>(" + MAPS
                + "float const*, float const*, float const*, int const*, float const*, "
                "int const*, float*, float*, int, int, int, int)",
        "bare": f"attn_fwd_kernel<__nv_bfloat16, {args}>",
    }


@pytest.mark.parametrize("mode, route, d", INSTANCES)
def test_forward_names_map_to_one_launch_key_and_kind(mode, route, d):
    want_key = tfa.KERNEL_NAMES[mode] + tfa.ROUTE_SUFFIX[route]
    want_kind = MODE_PREFIX[mode] + ROUTE_KIND[route]
    for form, name in _names(mode, route, d).items():
        assert tfa.launch_key(name) == want_key, form
        assert kernel_timing._kernel_kind(name) == want_kind, form
    assert want_key in tfa.KERNEL_LAUNCHES


@pytest.mark.parametrize("variant", [1, 2, 3, 4])
def test_ablation_variant_names_map_to_no_launch_key(variant):
    """Kernel 14's variants count under the bisect harness, not under the
    encoder attention."""
    for form, name in _names(tfa.ENCODER, tfa.FULL_ROW, 64, variant).items():
        assert tfa.launch_key(name) is None, form
        assert kernel_timing._kernel_kind(name) == "", form


def test_forward_instances_in_the_build():
    """The smoke's instantiation count is the one the wrappers can reach:
    every (mode, route, head width) and kernel 14's four other variants."""
    assert chip_smoke.FWD_INSTANCES == len(INSTANCES) + 4 == 19


@pytest.mark.parametrize("mangled, want", [
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi2ELi128ELi0EEEv14CUtensorMap_st",
     ("bf16", "3/2/128/0")),
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelIfLi0ELi0ELi64ELi4EEEv14CUtensorMap_stS1_",
     ("fp32", "0/0/64/4")),
    ("_ZN12_GLOBAL__N_118attn_bwd_dq_kernelI13__nv_bfloat16Li0ELi0ELi64EEEvPKT_", None),
])
def test_forward_instance_of_a_mangled_name(mangled, want):
    assert chip_smoke._fwd_instance(mangled) == want


@pytest.mark.parametrize("profiled, mangled", [
    ("void (anonymous namespace)::attn_fwd_kernel<__nv_bfloat16, 3, 2, 128, 0>(CUtensorMap_st)",
     "_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi2ELi128ELi0EEEv14CUtensorMap_st"),
    ("void (anonymous namespace)::attn_fwd_kernel<float, 0, 0, 64, 4>(CUtensorMap_st)",
     "_ZN12_GLOBAL__N_115attn_fwd_kernelIfLi0ELi0ELi64ELi4EEEv14CUtensorMap_stS1_"),
    ("void (anonymous namespace)::attn_bwd_dq_kernel<__nv_bfloat16, 2, 1, 64>(int)",
     "_ZN12_GLOBAL__N_118attn_bwd_dq_kernelI13__nv_bfloat16Li2ELi1ELi64EEEvPKT_"),
])
def test_profiled_and_mangled_names_give_one_instance(profiled, mangled):
    """The launch keys, the build log and the machine code read one pattern."""
    inst = tfa.kernel_instance(profiled)
    assert inst is not None and inst == tfa.kernel_instance(mangled)
    assert tfa.launch_key(profiled) == tfa.launch_key(mangled)


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li2ELi1ELi64ELi0EEEv14CUtensorMap_st
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0490*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*04a0*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*04b0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
        /*04c0*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_115attn_fwd_kernelIfLi2ELi1ELi64ELi0EEEv14CUtensorMap_st
        /*0490*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_118attn_bwd_dq_kernelI13__nv_bfloat16Li0ELi0ELi64EEEvPKT_
        /*0490*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
"""


def test_sass_counts_tensor_core_ops_per_forward_instance():
    counts = chip_smoke.sass_mma_counts(SASS)
    assert counts == {("bf16", "2/1/64/0"): {"HGMMA": 2, "HMMA": 0, "DEPBAR": 1},
                      ("fp32", "2/1/64/0"): {"HGMMA": 0, "HMMA": 0, "DEPBAR": 0}}


PTXAS = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi0ELi128ELi0EEEv14CUtensorMap_st' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi0ELi128ELi0EEEv14CUtensorMap_st
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1024 bytes cmem[0]
ptxas info    : Compiling entry function '_Z6kernelv' for 'sm_90a'
ptxas info    : Used 8 registers
"""


def test_ptxas_report_reads_registers_and_spills():
    report = ptxas_report(PTXAS)
    name = "_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi0ELi128ELi0EEEv14CUtensorMap_st"
    assert report[name] == {"stack": 0, "spill_stores": 8, "spill_loads": 4, "registers": 168}
    assert report["_Z6kernelv"] == {"registers": 8}


@pytest.mark.parametrize("dtype, raises", [(torch.bfloat16, True), (torch.float32, False)])
def test_misaligned_operand_is_refused_for_bf16_only(dtype, raises):
    """A contiguous view one element into a larger tensor: the bf16 forward's
    tensor maps cannot read it, the fp32 body can."""
    b, length = 2, 8
    inner = tfa.HEAD_DIMS[tfa.ENCODER][0] * 2
    flat = torch.zeros(b * length * inner + 1, dtype=dtype)
    shifted = flat[1:].view(b, length, inner)
    aligned = torch.zeros((b, length, inner), dtype=dtype)
    mask = torch.ones((b, length), dtype=torch.int32)
    rel = torch.zeros((32, 2))
    tfa._check_kernel_inputs(aligned, aligned, aligned, mask, rel, 2, 32)
    if raises:
        with pytest.raises(ValueError, match="16-byte boundary"):
            tfa._check_kernel_inputs(shifted, aligned, aligned, mask, rel, 2, 32)
        with pytest.raises(ValueError, match="bf16 v must start"):
            tfa._check_kernel_inputs(aligned, aligned, shifted, mask, rel, 2, 32)
    else:
        tfa._check_kernel_inputs(shifted, aligned, shifted, mask, rel, 2, 32)


def _scaled_case(t: int, heads: int, d: int):
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, t, heads * d)).astype(np.float32))
               .to(torch.bfloat16) for _ in range(3))
    return q, k, v, torch.ones((1, t), dtype=torch.int32)


def test_row_error_fails_a_row_sum_missing_a_key_tile():
    """Scaled causal attention at T 1024 (q scaled by d^-0.5, so late rows
    are diffuse): rows from 768 on divided by a row sum that misses one
    64-key tile come out 4.6-13.8% too large. The global bf16 limit, 2e-2 of
    max(1, max|ref|), passes that; the row check does not."""
    t, heads, d, scale = 1024, 2, 64, 64 ** -0.5
    q, k, v, mask = _scaled_case(t, heads, d)
    ref = tfa.scaled_causal_attention_reference(q, k, v, mask, heads, scale)
    qs = tfa.scale_queries(q, scale)
    dropped = mask.clone()
    dropped[:, 256:320] = 0
    factor = torch.exp(tfa.scaled_causal_attention_lse_reference(qs, k, mask, heads)
                       - tfa.scaled_causal_attention_lse_reference(qs, k, dropped, heads))
    bad = ref.float().view(1, t, heads, d) * factor.transpose(1, 2)[..., None]
    bad = bad.view(1, t, heads * d)
    bad[:, :768] = ref[:, :768].float()
    bad = bad.to(torch.bfloat16)
    err = (bad.float() - ref.float()).abs().max().item()
    assert 0 < err <= chip_smoke.BF16_REL_TOL * max(1.0, ref.float().abs().max().item())
    assert chip_smoke.row_error(bad, ref, heads) > chip_smoke.BF16_REL_TOL


def test_row_error_passes_bf16_rounding():
    """The same attention in bf16 against fp32 stays well inside the row
    limit: rounding costs each row well under 1% of its own size."""
    t, heads, d, scale = 1024, 2, 64, 64 ** -0.5
    q, k, v, mask = _scaled_case(t, heads, d)
    got = tfa.scaled_causal_attention_reference(q, k, v, mask, heads, scale)
    want = tfa.scaled_causal_attention_reference(q.float(), k.float(), v.float(), mask, heads,
                                                 scale)
    assert chip_smoke.row_error(got, want, heads) <= chip_smoke.BF16_REL_TOL / 4


def test_row_error_of_rows_with_no_valid_key():
    """An all-zero reference row must come out exactly zero."""
    want = torch.zeros((2, 3, 4))
    want[0] = 1.0
    got = want.clone()
    assert chip_smoke.row_error(got, want, 2) == 0.0
    got[1, 2, 3] = 1e-6
    assert chip_smoke.row_error(got, want, 2) == float("inf")


# The backward kernels: attn_bwd_dq_kernel<T, mode, route, D> and
# attn_bwd_dkv_kernel<...>, each with both bodies under one name, on the
# full-row and the long route.
BWD_INSTANCES = [(mode, route, d) for mode in tfa.KERNEL_NAMES
                 for route in (tfa.FULL_ROW, tfa.LONG) for d in tfa.HEAD_DIMS[mode]]
BWD_ARGS = ("const*, {t} const*, {t} const*, {t} const*, int const*, float const*, int const*, "
            "float const*, float const*, {t}*, {out}, int, int, int, int)")


def _bwd_names(part: str, mode: int, route: int, d: int) -> dict:
    """Profiled names of one backward instantiation: the parent version's
    (no tensor maps), this version's bf16 and fp32, and the mangled form."""
    args = f"{mode}, {route}, {d}"
    out = "float*" if part == "dq" else "{t}*"

    def full(t: str, maps: bool) -> str:
        return (f"void (anonymous namespace)::attn_bwd_{part}_kernel<{t}, {args}>("
                + (MAPS + "CUtensorMap_st, " if maps else "") + t + " "
                + BWD_ARGS.format(t=t, out=out.format(t=t)))

    n = len(f"attn_bwd_{part}_kernel")
    return {
        "parent_bf16": full("__nv_bfloat16", False),
        "bf16": full("__nv_bfloat16", True),
        "fp32": full("float", True),
        "mangled": f"_ZN12_GLOBAL__N_1{n}attn_bwd_{part}_kernelI13__nv_bfloat16Li{mode}ELi{route}"
                   f"ELi{d}EEEv14CUtensorMap_stS1_S1_S1_PKT_",
    }


@pytest.mark.parametrize("part", ["dq", "dkv"])
@pytest.mark.parametrize("mode, route, d", BWD_INSTANCES)
def test_backward_names_map_to_one_launch_key_and_kind(part, mode, route, d):
    """Both bodies of a backward kernel, and the parent version's, count
    under one launch key and time as one kind."""
    want_key = f"{tfa.KERNEL_NAMES[mode]}{tfa.ROUTE_SUFFIX[route]}_bwd_{part}"
    want_kind = MODE_PREFIX[mode] + ("" if route == tfa.FULL_ROW else "long_") + part
    for form, name in _bwd_names(part, mode, route, d).items():
        assert tfa.launch_key(name) == want_key, form
        assert chip_smoke._attn_instance(name, f"bwd_{part}")[1] == f"{mode}/{route}/{d}/0", form
        if form != "mangled":
            assert kernel_timing._kernel_kind(name) == want_kind, form
    assert want_key in tfa.KERNEL_LAUNCHES


def test_backward_instances_in_the_build():
    """The smoke's count of each backward kernel's instantiations: every
    (mode, head width) on the full-row and the long route."""
    assert chip_smoke.BWD_INSTANCES == len(BWD_INSTANCES) == 10
    assert chip_smoke.ATTN_PARTS == {"fwd": 19, "bwd_dq": 10, "bwd_dkv": 10}


@pytest.mark.parametrize("mangled, part, want", [
    ("_ZN12_GLOBAL__N_118attn_bwd_dq_kernelI13__nv_bfloat16Li0ELi1ELi64EEEv14CUtensorMap_st",
     "bwd_dq", ("bf16", "0/1/64/0")),
    ("_ZN12_GLOBAL__N_119attn_bwd_dkv_kernelIfLi3ELi0ELi128EEEv14CUtensorMap_stS1_",
     "bwd_dkv", ("fp32", "3/0/128/0")),
    ("_ZN12_GLOBAL__N_119attn_bwd_dkv_kernelIfLi3ELi0ELi128EEEv14CUtensorMap_stS1_",
     "bwd_dq", None),
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi2ELi128ELi0EEEv14CUtensorMap_st",
     "bwd_dkv", None),
])
def test_backward_instance_of_a_mangled_name(mangled, part, want):
    assert chip_smoke._attn_instance(mangled, part) == want


BWD_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119attn_bwd_dkv_kernelI13__nv_bfloat16Li3ELi0ELi128EEEv14CUtensorMap_stS1_S1_S1_PKT_
        /*0490*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
        /*04a0*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR8], R24, gsb0 ;
        /*04b0*/                   HGMMA.64x64x16.F32.BF16 R88, R8, gdesc[UR12], R88, gsb0 ;
        /*04c0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\tFunction : _ZN12_GLOBAL__N_118attn_bwd_dq_kernelIfLi1ELi1ELi64EEEv14CUtensorMap_stS1_S1_S1_PKT_
        /*0490*/                   FFMA R1, R2, R3, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li2ELi1ELi64ELi0EEEv14CUtensorMap_st
        /*0490*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
"""


def test_sass_counts_tensor_core_ops_per_backward_instance():
    """Each backward kernel's instantiations are counted on their own; the
    forward's default reading is unchanged."""
    assert chip_smoke.sass_mma_counts(BWD_SASS, "bwd_dkv") == {
        ("bf16", "3/0/128/0"): {"HGMMA": 3, "HMMA": 0, "DEPBAR": 1}}
    assert chip_smoke.sass_mma_counts(BWD_SASS, "bwd_dq") == {
        ("fp32", "1/1/64/0"): {"HGMMA": 0, "HMMA": 0, "DEPBAR": 0}}
    assert chip_smoke.sass_mma_counts(BWD_SASS) == {
        ("bf16", "2/1/64/0"): {"HGMMA": 1, "HMMA": 0, "DEPBAR": 0}}


# The quantized products (kernels 11/12): the build log, the machine code and
# the profiler name their three bodies.
@pytest.mark.parametrize("name, want", [
    ("_ZN12_GLOBAL__N_119quant_decode_kernelILi4ELi32EEEv14CUtensorMap_stS1_S1_NS_5QArgsE",
     ("decode", 4, 32)),
    ("void (anonymous namespace)::quant_decode_kernel<8, 64>(CUtensorMap_st, CUtensorMap_st)",
     ("decode", 8, 64)),
    ("_ZN12_GLOBAL__N_122quant_admission_kernelILi8EEEv14CUtensorMap_stS1_S1_NS_5QArgsE",
     ("admission", 8, 256)),
    ("void (anonymous namespace)::quant_admission_kernel<4>(CUtensorMap_st)",
     ("admission", 4, 256)),
    ("_ZN12_GLOBAL__N_119quant_matmul_kernelILb1EEEvNS_8OperandsE", ("simple", 4, 64)),
    ("void (anonymous namespace)::quant_matmul_kernel<false>((anonymous namespace)::Operands)",
     ("simple", 8, 64)),
    ("_ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li3ELi2ELi128ELi0EEEv14CUtensorMap_st",
     None),
])
def test_quant_kernel_names(name, want):
    from reprover_tpu_torch.ops import quant_matmul as qm

    assert qm.kernel_instance(name) == want
    assert chip_smoke._instance(name, "quant") == (
        None if want is None else ("bf16", "/".join(str(x) for x in want)))


QUANT_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119quant_decode_kernelILi4ELi32EEEv14CUtensorMap_stS1_S1_NS_5QArgsE
        /*0490*/                   HGMMA.64x32x16.F32.BF16 R24, R8, gdesc[UR4], R24 ;
        /*04a0*/                   HGMMA.64x32x16.F32.BF16 R24, R12, gdesc[UR8], R24, gsb0 ;
        /*04b0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\tFunction : _ZN12_GLOBAL__N_122quant_admission_kernelILi8EEEv14CUtensorMap_stS1_S1_NS_5QArgsE
        /*0490*/                   HGMMA.64x256x16.F32.BF16 R24, gdesc[UR4], R24, gsb0 ;
        /*04a0*/                   WARPGROUP.DEPBAR.LE gsb0, 0x0 ;
\t\tFunction : _ZN12_GLOBAL__N_119quant_matmul_kernelILb0EEEvNS_8OperandsE
        /*0490*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;
\t\tFunction : _ZN12_GLOBAL__N_115attn_fwd_kernelI13__nv_bfloat16Li2ELi1ELi64ELi0EEEv14CUtensorMap_st
        /*0490*/                   HGMMA.64x64x16.F32.BF16 R24, gdesc[UR4], RZ, !UPT ;
"""


def test_sass_counts_tensor_core_ops_per_quant_body():
    """A pipelined decode body passes (2 HGMMA, 1 wait), a serialized
    admission body (as many waits as HGMMAs) is told apart, the simple body
    keeps its wmma products; the attention's counts are untouched."""
    counts = chip_smoke.sass_mma_counts(QUANT_SASS, "quant")
    assert counts == {("bf16", "decode/4/32"): {"HGMMA": 2, "HMMA": 0, "DEPBAR": 1},
                      ("bf16", "admission/8/256"): {"HGMMA": 1, "HMMA": 0, "DEPBAR": 1},
                      ("bf16", "simple/8/64"): {"HGMMA": 0, "HMMA": 1, "DEPBAR": 0}}
    assert chip_smoke.sass_mma_counts(QUANT_SASS) == {
        ("bf16", "2/1/64/0"): {"HGMMA": 1, "HMMA": 0, "DEPBAR": 0}}


def test_quant_instances_in_the_build():
    """Decode at bits 8/4 x 32/64 rows and admission at bits 8/4: the
    instantiations the launcher reaches."""
    assert chip_smoke.QUANT_TMA_INSTANCES == 2 * 2 + 2 == 6


REORDER_SASS = """
        Function : _ZN48_GLOBAL__N__cc795b4d_15_beam_reorder_cu_67e5979a21reorder_append_kernelIiEEvNS_4ArgsE
        /*0690*/                   SYNCS.EXCH.64 URZ, [UR4], UR6 ;
        /*19c0*/                   UBLKCP.S.G [UR28], [UR26], UR5 ;
        /*1bc0*/                   UBLKCP.S.G [UR28], [UR26], UR5 ;
        /*27d0*/                   UBLKCP.G.S [UR8], [UR6], UR5 ;
        Function : _ZN48_GLOBAL__N__cc795b4d_15_beam_reorder_cu_67e5979a21reorder_append_kernelIlEEvNS_4ArgsE
        /*1a00*/                   UBLKCP.S.G [UR28], [UR26], UR5 ;
        Function : _Z21attn_fwd_kernelIfLi0ELi0ELi64ELi0EEvv
        /*0100*/                   UBLKCP.S.G [UR8], [UR6], UR5 ;
"""


def test_sass_counts_bulk_copies_per_reorder_instance():
    """Kernel 13's SASS check counts the bulk-copy opcodes of each index
    instantiation and nothing of other kernels; an instantiation without
    the stores (UBLKCP.G.S) is what the check refuses."""
    counts = chip_smoke.sass_bulk_copies(REORDER_SASS)
    names = sorted(counts)
    assert len(names) == 2 and all("reorder_append_kernel" in n for n in names)
    by_index = {("IiE" in n and "int32") or "int64": c for n, c in counts.items()}
    assert by_index == {"int32": {"UBLKCP.S.G": 2, "UBLKCP.G.S": 1},
                        "int64": {"UBLKCP.S.G": 1}}
