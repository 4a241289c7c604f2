"""The `sass` probe's reading of a `cuobjdump -sass` listing and of the
ptxas report (`fireflies_tpu_torch.perf_probe`), on the CPU: the loop over
pair tests found and counted by instruction class and per tested face, for
the Woop kernels' and the Moller-Trumbore kernels' marks.
"""

from fireflies_tpu_torch import perf_probe


_SASS = """
\tcode for sm_90a
\t\tFunction : _ZN9ff_stream13stream_kernelILb1ELb1EEEvPKf
        /*0000*/                   LDC R1, c[0x0][0x28] ;
        /*0010*/                   S2R R0, SR_TID.X ;
.L_x_1:
        /*0020*/                   LDGSTS.E.BYPASS.128 [R3], desc[UR4][R4.64] ;
        /*0030*/                   BAR.SYNC.DEFER_BLOCKING 0x0 ;
.L_x_2:
        /*0040*/                   LDS.128 R8, [R2] ;
        /*0050*/                   FFMA R5, R8, R3, -R9 ;
        /*0060*/                   FMUL R6, R8, R3 ;
        /*0070*/                   FSETP.GT.AND P0, PT, R5, 9.9999999600419720025e-13, PT ;
        /*0080*/                   FSETP.GT.AND P1, PT, R6, 9.9999999600419720025e-13, P0 ;
        /*0090*/              @P1  MOV R12, R5 ;
        /*00a0*/                   FSEL R13, R6, R5, P1 ;
        /*00b0*/                   IADD3 R2, R2, 0x10, RZ ;
        /*00c0*/              @!P2 BRA `(.L_x_2) ;
        /*00d0*/              @!P3 BRA 0x20 ;
        /*00e0*/                   EXIT ;
\t\tFunction : _Z9other_kernelPf
        /*0000*/                   FADD R1, R1, R1 ;
        /*0010*/                   EXIT ;
"""


_PTXAS = """== intersect_stream_general_culled.cu
ptxas info    : Compiling entry function '_ZN9ff_stream13stream_kernelILb1ELb1EEEvPKf' for 'sm_90a'
ptxas info    : Function properties for _ZN9ff_stream13stream_kernelILb1ELb1EEEvPKf
    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 72 registers, used 1 barriers, 12288 bytes smem
"""


def test_sass_inner_loop_counts():
    """The `sass` probe's reading of a listing: labels and hexadecimal
    targets resolve, the innermost back edge over a 16-byte shared load is
    the loop, its instructions are counted by class (a predicated MOV is a
    select) and per tested face (compares with float32(1e-12)), and the
    ptxas report gives registers and spills."""
    funcs = perf_probe.sass_functions(_SASS)
    name = "_ZN9ff_stream13stream_kernelILb1ELb1EEEvPKf"
    assert set(funcs) == {name, "_Z9other_kernelPf"}
    branches = [x[4] for x in funcs[name] if x[2] == "BRA"]
    assert branches == [0x40, 0x20]
    loop = perf_probe.inner_loop_counts(funcs[name])
    assert loop["loop_instructions"] == 9 and loop["loop_faces"] == 2 and loop["loop_lds128"] == 1
    assert loop["loop_classes"] == {"lds": 1, "ffma": 1, "fmul": 1, "fsetp": 2, "select": 2,
                                    "integer": 1, "control": 1}
    assert loop["per_face_total"] == 4.5 and loop["per_face"]["select"] == 1.0
    assert perf_probe.inner_loop_counts(funcs["_Z9other_kernelPf"]) == {}
    assert perf_probe.ptxas_resources(_PTXAS) == {
        name: {"registers": 72, "spill_store_bytes": 8, "spill_load_bytes": 4}}


_SASS_MT = """
\t\tFunction : _ZN12_GLOBAL__N_124intersect_general_kernelEPKf
        /*0000*/                   S2R R0, SR_TID.X ;
.L_x_7:
        /*0010*/                   LDS.128 R4, [R2] ;
        /*0020*/                   STS [R3], R4 ;
        /*0030*/              @!P4 BRA `(.L_x_7) ;
.L_x_8:
        /*0040*/                   LDS R8, [R2+0x40] ;
        /*0050*/                   LDS.64 R10, [R2+0x80] ;
        /*0060*/                   FFMA R5, R8, R10, -R11 ;
        /*0070*/                   FSETP.GE.AND P0, PT, R5, 9.9999997171806853657e-10, PT ;
        /*0080*/                   FSETP.GE.AND P1, PT, |R6|, 0x3089705f, P0 ;
        /*0090*/              @P1  MOV R12, R5 ;
        /*00a0*/              @!P2 BRA `(.L_x_8) ;
        /*00b0*/                   EXIT ;
"""


def test_sass_inner_loop_counts_moller_trumbore():
    """The `sass` probe on a Moller-Trumbore loop with scalar and 8-byte
    shared loads: its compares with float32(1e-9), in decimal or in bits,
    mark the tested faces, and the loop over them is read although a
    shorter loop holds the only 16-byte shared load."""
    funcs = perf_probe.sass_functions(_SASS_MT)
    (ins,) = funcs.values()
    loop = perf_probe.inner_loop_counts(ins)
    assert loop["loop_instructions"] == 7 and loop["loop_faces"] == 2 and loop["loop_lds128"] == 0
    assert loop["loop_classes"] == {"lds": 2, "ffma": 1, "fsetp": 2, "select": 1, "control": 1}
    assert loop["per_face_total"] == 3.5
