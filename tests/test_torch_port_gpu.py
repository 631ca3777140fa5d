"""rails_tpu_torch CUDA kernels vs their plain versions at edge shapes.

Marked `gpu`; every test skips without a CUDA device. On a card:
`python -m pytest --noconftest -m gpu tests/test_torch_port_gpu.py -q`
(`--noconftest` where jax is not installed: tests/conftest.py imports it).
`chip_smoke.py`
covers the serving shapes; these cover small, ragged and odd shapes and the
whole slice at the synthetic-small geometry.
"""

import numpy as np
import pytest
import torch

from rails_tpu.core.config import get_experiment_config
from rails_tpu_torch.data.datasets import SequenceDataset, generate_synthetic_sequences
from rails_tpu_torch.models.encoder import SequentialRecommender
from rails_tpu_torch.ops import hstu_block, mol_scoring
from rails_tpu_torch.similarity.layers import l2_normalize
from rails_tpu_torch.train.evaluation import get_eval_state, make_eval_step_fn

pytestmark = pytest.mark.gpu

TOL = {torch.float32: dict(rtol=1e-3, atol=1e-4), torch.bfloat16: dict(rtol=2e-2, atol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _k1_args(b, n, d, h, dqk, dv, max_seq_len, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    f = 2 * h * dv + 2 * h * dqk
    lengths = torch.randint(1, n, (b,), generator=g)
    ts = torch.cumsum(torch.randint(1, 10**6, (b, n), generator=g), dim=1).to(torch.int32)
    pos_w = 0.02 * torch.randn(2 * max_seq_len - 1, generator=g)
    i, j = torch.arange(n)[:, None], torch.arange(n)[None, :]
    args = dict(
        x=torch.randn(b, n, d, generator=g).to(dtype),
        colmask=(torch.arange(n)[None, :] < lengths[:, None]).float(),
        uvqk=(torch.randn(d, f, generator=g) / d**0.5).to(dtype),
        o_kernel=(torch.randn(h * dv, d, generator=g) / (h * dv) ** 0.5).to(dtype),
        o_bias=0.02 * torch.randn(d, generator=g),
        rel_pos=pos_w[j - i + max_seq_len - 1].contiguous(),
        ext=torch.cat([ts, ts[:, -1:]], dim=1),
        tsw=0.1 * torch.randn(128, generator=g),
    )
    kw = dict(num_heads=h, dqk=dqk, dv=dv, inv_n=1.0 / max_seq_len, eps=1e-6)
    return {k: v.to(device) for k, v in args.items()}, kw


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(5, 35, 32, 2, 16, 16, 35), (3, 97, 64, 4, 16, 16, 211), (2, 211, 256, 8, 32, 32, 211)],
    ids=["tiny", "ragged", "ml20m"],
)
def test_k1_kernel_matches_plain(cuda, shape, dtype):
    args, kw = _k1_args(*shape, dtype, cuda)
    before = hstu_block.fused_hstu_block.launches
    got = hstu_block.fused_hstu_block(**args, **kw)
    assert hstu_block.fused_hstu_block.launches == before + 1
    want = hstu_block.fused_hstu_block_reference(**args, **kw)
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def _k2_args(b, x, p_q, p_x, d_p, hd, dtype, device, seed=0):
    g = torch.Generator().manual_seed(seed)
    l = p_q * p_x
    tables = mol_scoring.prepare_fused_tables(
        l2_normalize(torch.randn(x, p_x, d_p, generator=g)).to(dtype),
        torch.randn(x, l, generator=g).to(dtype),
    )
    w = mol_scoring.MoLKernelWeights(
        torch.randn(l, hd, generator=g) / l**0.5, 0.1 * torch.randn(hd, generator=g),
        torch.randn(hd, l, generator=g) / hd**0.5, 0.1 * torch.randn(l, generator=g),
    )
    args = (
        l2_normalize(torch.randn(b, p_q, d_p, generator=g)).to(dtype).to(device),
        torch.randn(b, l, generator=g).to(device),
        tables.item_comp_t.to(device), tables.item_partial_t.to(device),
        mol_scoring.MoLKernelWeights(*(t.to(device) for t in w)), 0.05,
    )
    return args, x


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize(
    "shape", [(7, 100, 4, 2, 16, 32), (33, 300, 8, 4, 128, 128), (40, 513, 8, 4, 64, 96)],
    ids=["synthetic_small", "ml20m", "odd"],
)
def test_k2_kernel_matches_plain(cuda, shape, dtype):
    args, x = _k2_args(*shape, dtype, cuda)
    before = mol_scoring.fused_mol_scores_t.launches
    got = mol_scoring.fused_mol_scores_t(*args)[:, :x]
    assert mol_scoring.fused_mol_scores_t.launches == before + 1
    want = mol_scoring.fused_mol_scores_t_reference(*args)[:, :x]
    if dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-3)
    else:
        assert (got.argmax(dim=1) == want.argmax(dim=1)).float().mean().item() >= 0.99
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


def test_wrappers_reject_bad_cuda_inputs(cuda):
    args, kw = _k1_args(2, 16, 32, 2, 16, 16, 16, torch.float32, cuda)
    with pytest.raises(ValueError, match="uvqk"):
        hstu_block.fused_hstu_block(**{**args, "uvqk": args["uvqk"].T.contiguous().T}, **kw)
    k2, _ = _k2_args(4, 64, 8, 4, 32, 32, torch.float32, cuda)
    with pytest.raises(NotImplementedError, match="no kernel instance"):
        mol_scoring.fused_mol_scores_t(k2[0][:, :6].contiguous(), *k2[1:])


@pytest.mark.parametrize("method", ["MoLBruteForceTopK", "MoLBruteForceTopKFused"])
def test_slice_on_cuda_matches_cpu(cuda, method):
    """One tiny model, f32: the eval step on the card (kernels) and on the
    CPU (plain versions) return the same ranks and top-k ids."""
    cfg = get_experiment_config("synthetic-small")
    num_items = 300
    seqs = generate_synthetic_sequences(num_users=64, num_items=num_items, max_len=34, seed=1)
    ds = SequenceDataset(seqs, cfg.data.max_sequence_length, ignore_last_n=1)
    all_ids = np.arange(1, num_items + 1, dtype=np.int32)
    out = {}
    for device in ("cpu", cuda):
        model = SequentialRecommender(cfg, num_items, device=device,
                                      generator=torch.Generator().manual_seed(0))
        es = get_eval_state(model, all_ids, method, table_dtype=torch.float32, device=device)
        step = make_eval_step_fn(model, method, k=40, num_objects=es.num_objects,
                                 truncate_k_prime_to=60)
        batch = next(ds.batches(32, cfg.train.gr_output_length + 1, shuffle=False, device=device))
        out[str(device)] = [t.cpu() for t in step(es.topk_state, batch.features, batch.target_ids)]
    (r_cpu, i_cpu, s_cpu), (r_gpu, i_gpu, s_gpu) = out["cpu"], out[str(cuda)]
    torch.testing.assert_close(s_gpu, s_cpu, rtol=1e-4, atol=1e-4)
    assert (r_gpu == r_cpu).float().mean().item() >= 0.99
    assert (i_gpu == i_cpu).float().mean().item() >= 0.99
