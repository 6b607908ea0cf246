"""The work counts against the hand count at the shipped widths."""

from __future__ import annotations

import pytest

import bench_tiny  # noqa: F401  (paths)
from benchlib import work


def test_row_counts_at_the_shipped_widths():
    rows, latent = work.codenerf_layers(32, 256, 2, 1)
    assert work.macs(rows) == 13_648
    assert work.macs(work.occupancy_layers(128)) == 93_696
    assert work.macs(latent) == 4 * 256 * 32


def _step(n_cls, latent):
    rows, lat = work.codenerf_layers(32, latent, 2, 1)
    bg = work.occupancy_layers(128)
    return work.StepWork(
        n_cls=n_cls, n_obj=2 * n_cls, rays_per_cls=240, bins_obj=10,
        rays_bg=1200, bins_bg=14, cn_row_macs=work.macs(rows),
        cn_latent_macs=work.macs(lat), cn_params=work.n_params(rows),
        bg_row_macs=work.macs(bg), bg_params=work.n_params(bg), W=32)


@pytest.mark.parametrize("n_cls,latent,samples,gflop", [
    (20, 256, 64_800, 13.4), (3, 32, 24_000, 10.0)])
def test_step_counts(n_cls, latent, samples, gflop):
    w = _step(n_cls, latent)
    assert w.samples == samples
    assert round(w.step_flops() / 1e9, 1) == gflop
    assert w.cn_flops() + w.bg_flops() < w.step_flops()


def test_bound_takes_the_larger():
    assert work.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)


def test_trace_sorts_the_ports_kernels_into_fields():
    from benchlib import trace

    names = ["void (anonymous namespace)::gemm_kernel<32, 0, 4>(Gemm)",
             "void (anonymous namespace)::reduce_tiles(float const*, float*, int, int)",
             "void (anonymous namespace)::gemm_kernel<128, 0, 0>(Gemm)",
             "void (anonymous namespace)::reduce_tiles(float const*, float*, int, int)",
             "void (anonymous namespace)::elementwise_kernel_with_index<int, at::native::x>()",
             "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n"]
    ops = [trace.DeviceOp(n, 10.0 * i, 10.0 * i + 4.0)
           for i, n in enumerate(names)]
    t = trace.Trace(ops=ops, window_us=60.0, busy_us=24.0,
                    gaps=[("cudaGraphLaunch", 30.0), ("python", 6.0)],
                    steps=1)
    assert trace.field_times_us(t) == {"cn": 8.0, "occ": 8.0}
    assert [trace.is_gemm(n) for n in names] == [False] * 5 + [True]
    assert t.top_gaps(1) == [["cudaGraphLaunch", 3e-5]]
    assert t.top_ops()[0][1] == pytest.approx(8e-6)
