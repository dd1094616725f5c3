"""The source mutants of W4 (csrc/wavefront_shade.cu), each of which must
fail against the plain shading blocks on the CPU.

tests/test_torch_wavefront_shade_emu.py holds W4 itself; this file holds
its source mutations, on the same cases, built by g++ against the stand-in
runtime in parallel, apart from W4's own build so that `--dist loadfile`
runs the two files on two workers.  Each mutation of MUTANTS makes some
captured bounce of the ten scenes fail; each of QUEUE_MUTANTS makes some
type pattern of the queued entries fail, refractive and diffuse; each of
SUM_MUTANTS (built without W4_TORCH_CPU, the card's arithmetic) makes the
caps sum in registers differ from the general restatement of ATen's plan
at some row count and K; the mutant of SPLIT_MUTANTS makes the sum of rows
that ATen splits across blocks differ from its order, and that of
TREE_MUTANTS (built with the stand-in reporting the H100's SMs) the sum of
rows split across more blocks than a warp has lanes.
"""

import sys
from pathlib import Path

import pytest

from raytracer_tpu_torch.materials.base import MAT_DIFFUSE, MAT_REFRACTIVE

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_wavefront_shade_emu import (CARD_FLAGS, H100_SMS,  # noqa: E402,F401
                                            H100_SPLIT_SUMS, SCENES,
                                            SPLIT_SUMS, SUM_ROWS,
                                            _split_sum_differs, _sum_bits_differ,
                                            bounces,
                                            build_libs, differences,
                                            field_differences, patterns, plain,
                                            w4_out)

MUTANTS = {
    # the CPU's torch.sum order
    "sum_order": [("  return ((0.0f + x0) + x1) + x2;\n#else",
                   "  return ((0.0f + x0) + x2) + x1;\n#else")],
    # the Schlick continuation contracted
    "schlick_fma": [("beta[c] = F0 + (1.0f - F0) * schlick;",
                     "beta[c] = fmaf(1.0f - F0, schlick, F0);")],
    # the stratified draws at the wrong bounce
    "strat_bounce": [("if (B.s_mix != nullptr && dr == 0) {",
                      "if (B.s_mix != nullptr && dr == 1) {")],
    # a bilinear texture fetched nearest
    "nearest_for_bilinear": [("if (!(d[3] & 2)) {", "if (true) {")],
    # the split pattern's bit one level off
    "split_bit": [("bit = ((R.pattern[i] >> (cnt < 30 ? cnt : 30)) & 1) == 1;",
                   "bit = ((R.pattern[i] >> (cnt < 29 ? cnt + 1 : 30)) & 1) == 1;")],
    # the hero channel ignored
    "no_hero": [("    if (disp) {\n", "    if (false) {\n")],
    # the environment's alias taken on the wrong branch
    "alias_branch": [("if (!take) k = B.env_alias[k];",
                      "if (take) k = B.env_alias[k];")],
    # the spot light's smoothstep cone reassociated
    "cone": [("const float cone = (x * x) * (3.0f - 2.0f * x);",
              "const float cone = x * (x * (3.0f - 2.0f * x));")],
    # a texture's rows not flipped (v up)
    "texture_rows": [("(long long)t_rem(wrap_neg(iv), H) * W",
                      "(long long)t_rem(iv, H) * W")],
    # the lanes of the CPU's vector sum added in reverse
    "cpu_sum_lanes": [("  for (int l = 0; l < W4_CPU_VEC; ++l) s = s + lanes[l];",
                       "  for (int l = W4_CPU_VEC - 1; l >= 0; --l) s = s + lanes[l];")],
    # the refractive queue: the rays left after a block's last tile never
    # shaded
    "queue_flush": [("while (queued >= SHADE_BLOCK || (!tile && queued > 0)) {",
                     "while (queued >= SHADE_BLOCK) {")],
    # the warp prefix over a tile's (word, warp) counts off by one group
    "queue_prefix": [("        if (lane >= d) incl += up;",
                      "        if (lane > d) incl += up;")],
    # a round taken from the queue's front, not from its end
    "queue_round": [("if ((int)threadIdx.x < take) shade(queue[queued + threadIdx.x]);",
                     "if ((int)threadIdx.x < take) shade(queue[threadIdx.x]);")],
    # a caps lane that takes the cosine branch's height
    "caps_z": [("    *z = 1.0f + r2 * (cos_max - 1.0f);",
                "    *z = sqrtf(1.0f - r2);")],
    # the directional lights' shadow rays ignored
    "no_shadow": [("      const float see = B.occ != nullptr\n"
                   "          ? 1.0f - (float)B.occ[(long long)light * R.n + i] : 1.0f;\n"
                   "      float lv[3];\n"
                   "      for (int c = 0; c < 3; ++c) lv[c] = B.dir_color[3 * l + c] * NdotL;",
                   "      const float see = 1.0f;\n"
                   "      float lv[3];\n"
                   "      for (int c = 0; c < 3; ++c) lv[c] = B.dir_color[3 * l + c] * NdotL;")],
}
QUEUE_MUTANTS = ("queue_flush", "queue_prefix", "queue_round")

# the register sum's halving tree with its bit-reversed lane order off by one
SUM_MUTANTS = {
    "reg_sum_lanes": [("return lane_sum_reg<BX>(bit_reverse_c(LO, BX), K, term);",
                       "return lane_sum_reg<BX>(bit_reverse_c((LO + 1) % BX, BX), K, "
                       "term);")],
}


@pytest.fixture(scope="module")
def libs(tmp_path_factory):
    """{name: library}: each mutant of MUTANTS, g++ builds against the
    stand-in runtime with W4_TORCH_CPU, all started together."""
    return build_libs(tmp_path_factory, list(MUTANTS.items()))


# a row split across blocks: its head and tail terms added in every block,
# not in block 0 alone
SPLIT_MUTANTS = {
    "split_ends": [("  const bool ends = y == 0 && c == 0;",
                    "  const bool ends = y == 0;")],
}


# the last block's staged sums added by the lanes' tree, then the warps'
# (Reduce.cuh global_reduce takes the warps' first)
TREE_MUTANTS = {
    "staged_lanes_first": [("""  for (int rx = 0; rx < S.bx; ++rx) {
    const int x = bit_reverse(rx, S.bx);
    int yn = 0;
    for (int ry = 0; ry < S.by; ++ry) {
      const int y = bit_reverse(ry, S.by);
      float v = 0.0f;
      for (int c = x + y * S.bx; c < S.ctas; c += B) v = v + p[c];
      ys[yn++] = v;
      for (int m = ry + 1; (m & 1) == 0; m >>= 1, --yn) ys[yn - 2] = ys[yn - 2] + ys[yn - 1];
    }
    xs[xn++] = ys[0];
    for (int m = rx + 1; (m & 1) == 0; m >>= 1, --xn) xs[xn - 2] = xs[xn - 2] + xs[xn - 1];
  }""", """  for (int ry = 0; ry < S.by; ++ry) {
    const int y = bit_reverse(ry, S.by);
    int yn = 0;
    for (int rx = 0; rx < S.bx; ++rx) {
      const int x = bit_reverse(rx, S.bx);
      float v = 0.0f;
      for (int c = x + y * S.bx; c < S.ctas; c += B) v = v + p[c];
      ys[yn++] = v;
      for (int m = rx + 1; (m & 1) == 0; m >>= 1, --yn) ys[yn - 2] = ys[yn - 2] + ys[yn - 1];
    }
    xs[xn++] = ys[0];
    for (int m = ry + 1; (m & 1) == 0; m >>= 1, --xn) xs[xn - 2] = xs[xn - 2] + xs[xn - 1];
  }""")],
}


@pytest.fixture(scope="module")
def sum_libs(tmp_path_factory):
    """{name: library}: each mutant of SUM_MUTANTS and SPLIT_MUTANTS, built
    with the card's arithmetic (no W4_TORCH_CPU), and of TREE_MUTANTS, with
    the stand-in reporting the H100's SMs as well, for `ws.caps_sum`."""
    h100 = f"-DCUDA_EMU_SMS={H100_SMS}"
    return build_libs(tmp_path_factory, list(SUM_MUTANTS.items())
                      + list(SPLIT_MUTANTS.items())
                      + [(name, edits, h100) for name, edits in TREE_MUTANTS.items()],
                      CARD_FLAGS)


@pytest.mark.parametrize("mutant", list(MUTANTS))
def test_a_mutant_of_w4_fails(libs, bounces, plain, mutant):
    caught = any(differences(bounces[s], plain[s], libs[mutant], first=True)
                 for s in SCENES)
    assert caught, f"no case catches the mutant {mutant}"


def _queue_mutant_caught(libs, patterns, mt, mutant):
    return [key for key, (call, want) in patterns.items() if key[0] == mt
            and field_differences(w4_out(call, libs[mutant]), want)]


@pytest.mark.parametrize("mutant", QUEUE_MUTANTS)
def test_a_queue_mutant_fails_on_the_patterns(libs, patterns, mutant):
    caught = _queue_mutant_caught(libs, patterns, MAT_REFRACTIVE, mutant)
    assert caught, f"no refractive pattern catches the mutant {mutant}"


@pytest.mark.parametrize("mutant", QUEUE_MUTANTS)
def test_a_queue_mutant_fails_on_the_diffuse_patterns(libs, patterns, mutant):
    caught = _queue_mutant_caught(libs, patterns, MAT_DIFFUSE, mutant)
    assert caught, f"no diffuse pattern catches the mutant {mutant}"


@pytest.mark.parametrize("mutant", list(SUM_MUTANTS))
def test_a_sum_mutant_fails(sum_libs, mutant):
    assert any(_sum_bits_differ(sum_libs[mutant], n, K)
               for n in SUM_ROWS for K in range(2, 128)), mutant


@pytest.mark.parametrize("mutant", list(SPLIT_MUTANTS))
def test_a_split_sum_mutant_fails(sum_libs, mutant):
    assert any(_split_sum_differs(sum_libs[mutant], n, K) for n, K in SPLIT_SUMS), \
        mutant


@pytest.mark.parametrize("mutant", list(TREE_MUTANTS))
def test_a_split_tree_mutant_fails(sum_libs, mutant):
    assert any(_split_sum_differs(sum_libs[mutant], n, K, H100_SMS)
               for n, K in H100_SPLIT_SUMS), mutant
