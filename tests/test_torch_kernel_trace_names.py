"""``ops.TRACE_NAMES`` against the fused AA kernels' symbols.

Phases U7, U8 and U10 of ``chip_smoke.py`` count each kernel in a profiler
trace by the pattern of its ``__global__`` name.  The forward K3
(``csrc/aa_fused.cu``, ``aa_fused_kernel<H>``) and K3b
(``csrc/aa_fused_bf16.cu``, ``aa_fused_bf16_kernel<H>``), and the backward
K4 (``csrc/aa_fused_bwd.cu``, ``aa_fused_bwd_kernel<H>``) and K4b
(``csrc/aa_fused_bwd_bf16.cu``, ``aa_fused_bwd_bf16_kernel<H>``) are four
kernels of four sources; each pattern must match its own kernel at both
head counts and never another's.
"""
import re
from pathlib import Path

import pytest

from trajsde_tpu_torch.ops import TRACE_NAMES, traced_launches

CSRC = Path(__file__).resolve().parents[1] / "trajsde_tpu_torch" / "csrc"
# (the launch count's name, the source, the __global__ function)
KERNELS = (("aa_fused_bwd", "aa_fused_bwd.cu", "aa_fused_bwd_kernel"),
           ("aa_fused_bwd_bf16", "aa_fused_bwd_bf16.cu", "aa_fused_bwd_bf16_kernel"))
FORWARD = (("aa_fused", "aa_fused.cu", "aa_fused_kernel"),
           ("aa_fused_bf16", "aa_fused_bf16.cu", "aa_fused_bf16_kernel"))


def trace_name(source: str, kernel: str, heads: int) -> str:
    """The name a trace gives ``kernel`` at ``heads``, from its definition
    in ``source``: a ``__global__`` template on the head count alone."""
    text = (CSRC / source).read_text()
    m = re.search(r"template <([^>]*)>\s*__global__ void __launch_bounds__\([^)]*\)\s*"
                  rf"{kernel}\(", text)
    assert m, f"{source} defines no __global__ {kernel}"
    assert m.group(1) == "int H", f"{kernel}'s template is <{m.group(1)}>, not <int H>"
    return f"void (anonymous namespace)::{kernel}<{heads}>(float const*, float const*, float*)"


@pytest.mark.parametrize("heads", [8, 4])
def test_each_backward_pattern_counts_its_own_kernel_only(heads):
    for count, source, kernel in KERNELS:
        name = trace_name(source, kernel, heads)
        assert re.search(TRACE_NAMES[count], name), (count, name)
        launched = traced_launches([name, name])
        assert launched[count] == 2, launched
        assert sum(launched.values()) == 2, launched


@pytest.mark.parametrize("heads", [8, 4])
def test_each_forward_pattern_counts_its_own_kernel_only(heads):
    for count, source, kernel in FORWARD:
        name = trace_name(source, kernel, heads)
        assert re.search(TRACE_NAMES[count], name), (count, name)
        launched = traced_launches([name, name, name])
        assert launched[count] == 3, launched
        assert sum(launched.values()) == 3, launched


def test_the_f32_patterns_do_not_count_the_bf16_forms():
    """K5b is K5's template with BF = true; K3b and K4b have names of their
    own."""
    names = [trace_name("aa_fused_bf16.cu", "aa_fused_bf16_kernel", 8),
             "void (anonymous namespace)::aa_attention_kernel<4, true>(float const*)",
             trace_name("aa_fused_bwd_bf16.cu", "aa_fused_bwd_bf16_kernel", 4)]
    launched = traced_launches(names)
    assert {k: v for k, v in launched.items() if v} == {
        "aa_fused_bf16": 1, "aa_attention_bf16": 1, "aa_fused_bwd_bf16": 1}
