"""The CUDA kernels against their plain PyTorch versions, on the card.

These tests carry the ``cuda`` marker and skip where torch finds no CUDA
device (there is no CPU mode for a CUDA kernel); ``chip_smoke.py`` runs the
same comparisons at the main path's full shapes. On a machine with a card:
``PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py``.
"""

import numpy as np
import pytest
import torch

from repro_torch.core import (Assignment, BalanceConfig, Hash32,
                              RebalanceController)
from repro_torch.configs import smoke_config
from repro_torch.kernels import (RoutingTable, flash_attention,
                                 flash_attention_plain, key_stats,
                                 key_stats_plain, route_keys, route_plain)
from repro_torch.kernels.key_stats import key_sums
from repro_torch.launch.serve import init_request
from repro_torch.train.train_step import make_serve_step
from repro_torch.streams import KeyedStage, MergeCounts, WordCount, WorkloadGen

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("n,a", [(1, 1), (1000, 128), (300_001, 4096),
                                 (70_000, 16384)])
def test_routing_kernel_matches_plain(cuda, n, a):
    rng = np.random.default_rng(n)
    keys = rng.integers(0, 2**31 - 1, size=n).astype(np.int32)
    tk = np.full(a, -1, np.int32)
    tk[:a // 2] = rng.choice(np.unique(keys), size=a // 2, replace=False) \
        if n >= a else np.arange(a // 2)
    td = rng.integers(0, 15, size=a).astype(np.int32)
    table = RoutingTable.from_arrays(tk, td, cuda)
    kt = torch.from_numpy(keys).to(cuda)
    before = route_keys.launches
    got = route_keys(kt, table, 15, seed=3)
    torch.cuda.synchronize()
    assert route_keys.launches == before + 1
    torch.testing.assert_close(got, route_plain(kt, table, 15, seed=3),
                               rtol=0, atol=0)


def test_routing_kernel_routes_key_minus_one_to_the_first_empty_slot(cuda):
    """Keys -1 and -2 against a table with empty slots: -1 takes the first
    empty slot's dest (0), -2 routes by its hash, as the JAX package's
    ``ref.routing_lookup`` gives ([0, 8, 3, 6])."""
    keys = torch.tensor([-1, -2, 5, 7], dtype=torch.int32, device=cuda)
    table = RoutingTable.from_arrays(np.array([5, -1, -1, -1], np.int32),
                                     np.array([3, 0, 0, 0], np.int32), cuda)
    before = route_keys.launches
    got = route_keys(keys, table, 13, seed=5)
    torch.cuda.synchronize()
    assert route_keys.launches == before + 1
    assert got.cpu().tolist() == [0, 8, 3, 6]
    assert route_plain(keys, table, 13, seed=5).cpu().tolist() == [0, 8, 3, 6]


@pytest.mark.parametrize("offset", [0, 1, 2, 3])
@pytest.mark.parametrize("a,n_real", [(1, 0), (128, 64), (4096, 3000),
                                      (16384, 16381), (32768, 24000)])
def test_routing_kernel_edge_keys_and_offsets(cuda, a, n_real, offset):
    """The hash-table kernel against ``route_plain``, bit-identical: tables
    of 1 to 16384 slots (at most 192 KB) and one of 32768 past that, empty
    slots with different dests, keys -1, -2, INT32_MIN and 2**31 - 1, and
    key arrays that start 0-3 elements off the 16-byte grid, so the scalar
    head and tail run."""
    rng = np.random.default_rng(a + offset)
    tk = np.full(a, -1, np.int32)
    tk[:n_real] = rng.choice(2**31 - 1, size=n_real, replace=False)
    td = rng.integers(0, 13, size=a).astype(np.int32)
    tk = tk[rng.permutation(a)]
    table = RoutingTable.from_arrays(tk, td, cuda)
    real = tk[tk >= 0]
    keys = np.concatenate([
        rng.choice(real, size=5000) if real.size else [],
        rng.integers(-2**31, 2**31 - 1, size=5003),
        [-1, -2, -(2**31), 2**31 - 1, -1]]).astype(np.int32)
    kt = torch.from_numpy(rng.permutation(keys)).to(cuda)[offset:]
    assert kt.data_ptr() % 16 == 4 * offset
    before = route_keys.launches
    got = route_keys(kt, table, 13, seed=7)
    torch.cuda.synchronize()
    assert route_keys.launches == before + 1
    torch.testing.assert_close(got, route_plain(kt, table, 13, seed=7),
                               rtol=0, atol=0)


@pytest.mark.parametrize("cost_dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("offset", [0, 3])
def test_key_stats_kernel_hot_key(cuda, cost_dtype, offset):
    """A zipf z = 1.2 stream with one key in half the tuples (the warp
    groups and the block cache): g(k) exact, c(k) within float32
    reordering, 2 g(k) 2^-24 |c(k)| (costs > 0)."""
    rng = np.random.default_rng(21 + offset)
    keys = rng.zipf(1.2, size=1_000_003) % 70_000
    keys[rng.random(keys.size) < 0.5] = 11
    keys = torch.from_numpy(keys.astype(np.int32)).to(cuda)[offset:]
    costs = torch.from_numpy(rng.uniform(0.5, 1.5, size=1_000_003)) \
        .to(cuda, cost_dtype)[offset:]
    before = key_stats.launches
    freq, cost = key_stats(keys, costs, 70_000)
    torch.cuda.synchronize()
    assert key_stats.launches == before + 1
    pfreq, pcost = key_stats_plain(keys, costs, 70_000)
    torch.testing.assert_close(freq, pfreq, rtol=0, atol=0)
    assert int(freq[11]) > 490_000
    assert bool(((cost - pcost).abs()
                 <= 2 * pfreq * 2.0**-24 * pcost.abs() + 1e-30).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_key_sums_kernel_matches_two_plain_calls(cuda, dtype):
    """The stats path's one launch for two weights against two plain calls:
    unique keys (one term a key) are exact, repeated keys within float32
    reordering."""
    rng = np.random.default_rng(5)
    for keys_np in (rng.permutation(300_000)[:200_001],
                    rng.integers(-5, 50_000, size=200_001)):
        keys = torch.from_numpy(keys_np.astype(np.int32)).to(cuda)
        w1 = torch.from_numpy(rng.uniform(0.1, 9.0, size=keys.numel())) \
            .to(cuda, dtype)
        w2 = torch.from_numpy(rng.integers(1, 40, size=keys.numel())
                              .astype(np.float64)).to(cuda, dtype)
        before = key_stats.launches
        s1, s2 = key_sums(keys, w1, w2, 300_000)
        torch.cuda.synchronize()
        assert key_stats.launches == before + 1
        count = key_stats_plain(keys, w1, 300_000)[0]
        for got, w in ((s1, w1), (s2, w2)):
            want = key_stats_plain(keys, w, 300_000)[1]
            assert bool(((got - want).abs()
                         <= 2 * count * 2.0**-24 * want.abs()).all())


@pytest.mark.parametrize("n,num_keys", [(1, 1), (5000, 33), (1_000_000,
                                                             1 << 20)])
def test_key_stats_kernel_matches_plain(cuda, n, num_keys):
    rng = np.random.default_rng(n)
    keys = torch.from_numpy(rng.integers(-3, num_keys + 3, size=n)
                            .astype(np.int32)).to(cuda)
    costs = torch.from_numpy(rng.uniform(0.1, 3.0, size=n)).to(cuda)
    before = key_stats.launches
    freq, cost = key_stats(keys, costs, num_keys)
    torch.cuda.synchronize()
    assert key_stats.launches == before + 1
    pfreq, pcost = key_stats_plain(keys, costs, num_keys)
    torch.testing.assert_close(freq, pfreq, rtol=0, atol=0)
    torch.testing.assert_close(cost, pcost, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("op", [WordCount, MergeCounts])
def test_device_stage_on_cuda_matches_cpu(cuda, op):
    def stage(device):
        c = RebalanceController(Assignment(Hash32(7, seed=4)),
                                BalanceConfig(theta_max=0.02, window=3))
        return KeyedStage(op(), c, window=3, state_backend="device",
                          substrate="kernels", device=device)

    stages = [stage(cuda), stage("cpu")]
    gens = [WorkloadGen(k=3000, z=1.1, f=0.8, seed=5, window=3)
            for _ in stages]
    for i in range(4):
        for gen, st in zip(gens, stages):
            if i:
                gen.interval(st.controller.assignment)
            keys = gen.draw_tuples(5000).astype(np.int64)
            st.process_interval_arrays(keys, keys % 97)
    for rg, rc in zip(*(s.reports for s in stages)):
        assert (rg.theta, rg.table_size, rg.migrated_bytes) == \
            (rc.theta, rc.table_size, rc.migrated_bytes)
        np.testing.assert_array_equal(rg.task_loads, rc.task_loads)
    assert stages[0].outputs == stages[1].outputs


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,t,s,d,window", [
    (1, 2, 2, 64, 64, 32, 0),        # MHA square
    (2, 8, 2, 128, 128, 64, 0),      # GQA 4:1
    (1, 4, 1, 96, 96, 32, 0),        # MQA, ragged T
    (1, 4, 4, 1, 256, 64, 0),        # decode: one query vs KV cache
    (1, 8, 2, 17, 250, 32, 0),       # chunked decode, ragged both axes
    (1, 4, 2, 192, 192, 32, 16),     # sliding windows
    (1, 4, 2, 192, 192, 32, 300),
    (1, 2, 1, 100, 40, 16, 0),       # T > S: fully masked rows give 0
    (2, 16, 8, 300, 300, 240, 100),  # gemma3's head dim
    (1, 4, 1, 17, 250, 256, 0),      # the largest head dim
])
def test_flash_kernel_matches_plain(cuda, b, hq, hkv, t, s, d, window, dtype,
                                    atol):
    g = torch.Generator(device=cuda).manual_seed(t * s + d)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=True,
                                           window=window).float(),
        rtol=0, atol=atol)


def _bf16_inputs(cuda, shape, seed):
    b, hq, hkv, t, s, d = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    return [torch.randn(sh, generator=g, device=cuda).to(torch.bfloat16)
            for sh in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d))]


def _check_bf16_launch(q, k, v, window):
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=True, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    assert got.dtype == torch.bfloat16 and got.shape == q.shape
    assert got.is_contiguous()
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=True,
                                           window=window).float(),
        rtol=0, atol=2e-2)


@pytest.mark.parametrize("shape,window", [
    ((1, 16, 8, 2048, 2048, 240), 1024),  # the serve path's window layer
    ((1, 16, 8, 2048, 2048, 240), 0),     # and its global layer, at B = 1
    ((2, 16, 1, 130, 130, 240), 0),       # ragged T in every head
    ((2, 16, 1, 130, 130, 240), 64),
    ((2, 4, 2, 200, 200, 8), 0),          # qwen2 smoke's head dim
    ((2, 4, 2, 150, 170, 20), 0),         # padded to 24 columns
    ((1, 4, 1, 77, 300, 20), 50),
])
def test_flash_wgmma_kernel_matches_plain(cuda, shape, window):
    """The bf16 kernel (TMA + wgmma) at the serve shapes and at the edges of
    its layout: a ragged last query tile must read zeros, not the next
    head's rows; a head dim off the 8-column grid is padded by the
    wrapper."""
    _check_bf16_launch(*_bf16_inputs(cuda, shape, seed=sum(shape) + window),
                       window)


@pytest.mark.parametrize("dtype,atol", [(torch.float32, 2e-5),
                                        (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,hq,hkv,t,s,d,window", [
    (1, 4, 2, 192, 192, 32, 16),     # every key after pos - window
    (2, 8, 2, 130, 170, 64, 50),     # ragged, queries right-aligned
    (1, 24, 8, 256, 256, 64, 100),   # granite-moe's heads (3:1, D = 64)
])
def test_flash_kernel_non_causal_window_matches_plain(cuda, b, hq, hkv, t, s,
                                                      d, window, dtype, atol):
    """``causal=False`` with a window: the kernel admits every key after
    ``pos - window``, those past the query's position too, as the plain
    version does."""
    g = torch.Generator(device=cuda).manual_seed(t + s + d + window)
    q, k, v = (torch.randn(shape, generator=g, device=cuda).to(dtype)
               for shape in ((b, hq, t, d), (b, hkv, s, d), (b, hkv, s, d)))
    before = flash_attention.launches
    got = flash_attention(q, k, v, causal=False, window=window)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + 1
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=False,
                                           window=window).float(),
        rtol=0, atol=atol)


@pytest.mark.parametrize("which", [0, 1, 2])
def test_flash_wgmma_kernel_takes_misaligned_inputs(cuda, which):
    """A tensor whose storage starts off TMA's 16-byte grid is copied by the
    wrapper, not read from the wrong address."""
    shape = (1, 8, 4, 96, 96, 64)
    qkv = _bf16_inputs(cuda, shape, seed=11 + which)
    flat = torch.empty(qkv[which].numel() + 1, dtype=torch.bfloat16,
                       device=cuda)
    moved = flat[1:].view(qkv[which].shape)
    moved.copy_(qkv[which])
    assert moved.data_ptr() % 16 != 0
    qkv[which] = moved
    _check_bf16_launch(*qkv, window=0)


def test_flash_phase_clocks_build(cuda, tmp_path):
    """Built with -DFLASH_PHASE_CLOCKS (scripts/flash_ab.py --phases), the
    bf16 kernel still matches the plain version and its consumer warps'
    clocks add up to the phases it reports."""
    import ctypes
    import subprocess
    from repro_torch.kernels import _build
    lib_path = tmp_path / "flash_clocks.so"
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-DFLASH_PHASE_CLOCKS",
                    "-o", str(lib_path),
                    str(_build.CSRC / "flash_attention.cu")], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(lib_path))
    launch = lib.flash_attention_launch
    launch.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 9 + \
        [ctypes.c_float, ctypes.c_void_p]
    launch.restype = ctypes.c_int
    read = lib.flash_attention_phase_clocks
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    read.restype = ctypes.c_int
    clocks = (ctypes.c_ulonglong * 8)()
    assert read(clocks) == 0
    q, k, v = _bf16_inputs(cuda, (1, 4, 2, 300, 300, 64), seed=7)
    o = torch.empty_like(q)
    assert launch(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), 1,
                  1, 4, 2, 300, 300, 64, 1, 100, 64 ** -0.5,
                  torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert read(clocks) == 0
    # the GEMMs and the softmax ran; the counters cleared on reading
    assert clocks[2] > 0 and clocks[3] > 0 and clocks[5] > 0
    assert read(clocks) == 0 and sum(clocks) == 0
    torch.testing.assert_close(
        o.float(), flash_attention_plain(q, k, v, causal=True,
                                         window=100).float(),
        rtol=0, atol=2e-2)


@pytest.mark.parametrize("arch", ["gemma3_12b", "qwen2_7b"])
def test_cache_free_serve_step_on_cuda(cuda, arch):
    """One flash launch per layer; the logits agree with the plain
    attention path within the serve tolerance (atol 0.3, rtol 0.05)."""
    cfg = smoke_config(arch)
    params, tokens = init_request(cfg, 2, 80, cuda,
                                  torch.Generator(device=cuda).manual_seed(1))
    before = flash_attention.launches
    flash, _ = make_serve_step(cfg, use_flash=True)(
        params, None, {"tokens": tokens}, 0)
    torch.cuda.synchronize()
    assert flash_attention.launches == before + cfg.n_layers
    plain, _ = make_serve_step(cfg)(params, None, {"tokens": tokens}, 0)
    torch.testing.assert_close(flash.float(), plain.float(), rtol=0.05,
                               atol=0.3)
