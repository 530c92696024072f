"""The integer term of chip_smoke.py's bounds, on the CPU.

chip_smoke.py counts the hash's 32-bit integer instructions an element in
the SASS of the built keep-mask kernel: the instructions that compute the
data of its vector loop's 16-byte stores (the hash and the byte pack), not
the store's address, the loop counter's update and compare, or the branch.
These tests run without a CUDA toolkit, so they hold the parser and the
slice against a short loop of the same shape written out by hand: two
16-element stores, each with its address, and a counter update and
compare beside the data's instructions.
"""

import chip_smoke

# a grid-stride loop: R6:R7 the counter, R12:R13 and R14:R15 the two
# stores' addresses, R8-R11 and R20-R23 their data
SASS = """
\t\tFunction : _ZN12_GLOBAL__N_116keep_mask_kernelEPhmjj
        /*0000*/                   S2R R5, SR_CTAID.X ;
        /*0010*/                   IMAD.WIDE.U32 R6, R5, 0x100, RZ ;
        /*0020*/                   IMAD R16, R6, -0x1c886470, R4 ;
        /*0030*/                   SHF.R.U32.HI R17, RZ, 0x10, R16 ;
        /*0040*/                   LOP3.LUT R8, R17, R16, RZ, 0x3c, !PT ;
        /*0050*/                   IMAD R9, R8, -0x7a143595, RZ ;
        /*0060*/                   ISETP.GE.U32.AND P1, PT, R9, R5, PT ;
        /*0070*/                   SEL R10, RZ, 0x1, P1 ;
        /*0080*/                   PRMT R11, R10, 0x7604, R9 ;
        /*0090*/                   LEA R12, P0, R6, UR12, 0x4 ;
        /*00a0*/                   LEA.HI.X R13, R6, UR13, R7, 0x4, P0 ;
        /*00b0*/                   STG.E.128 desc[UR4][R12.64], R8 ;
        /*00c0*/                   VIADD R20, R16, 0x9e3779b9 ;
        /*00d0*/                   LOP3.LUT R21, R20, R16, RZ, 0x3c, !PT ;
        /*00e0*/                   IADD3 R22, R21, 0x1, RZ ;
        /*00f0*/                   SEL R23, RZ, 0x1, P1 ;
        /*0100*/                   IADD3 R14, P2, R12, 0x10, RZ ;
        /*0110*/                   IADD3.X R15, RZ, R13, RZ, P2, !PT ;
        /*0120*/                   STG.E.128 desc[UR4][R14.64], R20 ;
        /*0130*/                   IMAD.WIDE.U32 R6, R0, 0x100, R6 ;
        /*0140*/                   ISETP.GE.U32.AND P0, PT, R6, UR7, PT ;
        /*0150*/                   ISETP.GE.U32.AND.EX P0, PT, R7, UR8, PT, P0 ;
        /*0160*/              @!P0 BRA 0x20 ;
        /*0170*/                   EXIT ;
        /*0180*/                   BRA 0x180;
"""


def test_vector_loop_is_the_backward_branch_with_the_stores():
    body = chip_smoke.vector_loop(SASS, "keep_mask_kernel")
    assert [op for op, _, _ in body][0] == "IMAD"
    assert body[-1] == ("BRA", " 0x20 ", "@!P0 ")
    assert len(body) == 21


def test_store_data_slice_leaves_out_address_counter_and_compare():
    body = chip_smoke.vector_loop(SASS, "keep_mask_kernel")
    taken = [body[j][0] for j in chip_smoke.store_data_slice(body)]
    assert taken == ["IMAD", "SHF.R.U32.HI", "LOP3.LUT", "IMAD",
                     "ISETP.GE.U32.AND", "SEL", "PRMT", "VIADD", "LOP3.LUT",
                     "IADD3", "SEL"]
    # the whole loop: 18 integer instructions, 15 on the ALU pipe; the
    # stores' data: 11, 9 on the ALU pipe (IMAD and its wide form on FMA)
    assert chip_smoke.int_counts([op for op, _, _ in body]) == (18, 15)
    assert chip_smoke.int_counts(taken) == (11, 9)


def test_defs_and_uses_of_the_operand_forms():
    du = chip_smoke.sass_defs_uses
    assert du("ISETP.GE.U32.AND", " P5, PT, R24, R5, PT ", "") == (
        {"P5"}, {"R24", "R5"})
    assert du("LEA", " R12, P0, R6, UR12, 0x4 ", "") == (
        {"R12", "P0"}, {"R6", "UR12"})
    assert du("IADD3.X", " R8, R3, UR11, RZ, P0, !PT ", "") == (
        {"R8"}, {"R3", "UR11", "P0"})
    assert du("IMAD.WIDE.U32", " R6, R0, 0x100, R6 ", "") == (
        {"R6", "R7"}, {"R0", "R6", "R7"})
    assert du("STG.E.128", " desc[UR4][R12.64], R8 ", "") == (
        set(), {"UR4", "R12", "R13", "R8"})
    assert du("SEL", " R10, RZ, 0x1, !P5 ", "@P2 ") == (
        {"R10"}, {"P5", "P2"})


def test_bound_names_the_integer_term_when_it_is_the_largest():
    saved = dict(chip_smoke.HASH)
    try:
        chip_smoke.HASH.update(int_per_s=1e12, per_element=10.0)
        # 1e6 elements: 1e7 instructions at 1e12/s = 0.01 ms, above 1e6
        # bytes at HBM_BYTES_PER_S
        ms, kind = chip_smoke.bound(1e6, 0, "fp32", hashed=1e6)
        assert kind == "integer operations" and abs(ms - 0.01) < 1e-12
        ms, kind = chip_smoke.bound(1e9, 0, "fp32", hashed=1e6)
        assert kind == "bytes"
    finally:
        chip_smoke.HASH.update(saved)
