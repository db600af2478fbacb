"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit): the roofline's constants.

Copied from ``chip_smoke.py`` (``PEAK_BF16_FLOPS``, ``PEAK_F32_FLOPS``,
``PEAK_BYTES``, ``SFU_PER_CLOCK_SM``) and ``src/repro_torch/core/
roofline.py`` (``HW``) at commit 5ccc2ae.
"""

PEAK_BF16_FLOPS = 989e12      # FLOP/s, tensor cores, dense
PEAK_F32_FLOPS = 67e12        # FLOP/s, outside the tensor cores
PEAK_BYTES = 3.35e12          # B/s, HBM3
# special-function unit (ex2) results per clock per SM, compute
# capability 9.0 (CUDA C++ programming guide)
SFU_PER_CLOCK_SM = 16
# the H100 SXM's SM count and top SM clock (data sheet): the SFU's peak
SMS = 132
SM_CLOCK_HZ = 1.98e9
PEAK_EX2 = SMS * SFU_PER_CLOCK_SM * SM_CLOCK_HZ   # ex2 results/s
