"""PyTorch port, models: EigenFunctions and the exp-form tanh against the
JAX package, with the JAX model's parameters transplanted; the stacked
heads' products split along the batch axis against the whole products,
and the rule that picks one or the other."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from colvarsfinder_tpu.models import EigenFunctions as JaxEigenFunctions
from colvarsfinder_tpu.models.module import _tanh_precise as jax_tanh

from colvarsfinder_tpu_torch import logging_utils
from colvarsfinder_tpu_torch.models import EigenFunctions
from colvarsfinder_tpu_torch.models.module import (
    SPLIT_MIN_ROWS,
    _stacked_apply,
    _tanh_precise,
    _unwrapped,
    split_count,
    stacked_mlp_apply,
)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np_params(model):
    return [{"weight": np.asarray(p["weight"]), "bias": np.asarray(p["bias"])}
            for p in model.params]


@pytest.mark.parametrize("k,dims", [(1, [5, 7, 1]), (3, [12, 10, 10, 1])])
def test_eigenfunctions_forward_matches_jax(k, dims):
    jm = JaxEigenFunctions(dims, k, seed=3)
    tm = EigenFunctions.from_numpy(_np_params(jm), device="cpu")
    x = np.random.default_rng(0).standard_normal((64, dims[0])).astype(np.float32)
    y_j = np.asarray(jm(jnp.asarray(x)))
    y_t = tm(torch.from_numpy(x)).detach().numpy()
    assert y_t.shape == (64, k)
    # f32 products of a few layers in two libraries: rounding order only
    np.testing.assert_allclose(y_t, y_j, atol=1e-6)
    # a single state, like torch.nn.Linear on a vector
    np.testing.assert_allclose(
        tm(torch.from_numpy(x[0])).detach().numpy(), y_j[0], atol=1e-6
    )


def test_from_numpy_and_cv_params():
    jm = JaxEigenFunctions([4, 6, 1], 2, seed=1)
    tm = EigenFunctions.from_numpy(_np_params(jm))
    assert tm.layer_dims == (4, 6, 1) and tm.k == 2
    for (name_j, p_j), (name_t, p_t) in zip(jm.get_params_of_cv(1),
                                            tm.get_params_of_cv(1)):
        assert name_j == name_t
        np.testing.assert_array_equal(np.asarray(p_j), p_t.detach().numpy())


def test_reordered_matches_jax():
    jm = JaxEigenFunctions([6, 8, 8, 1], 3, seed=2)
    tm = EigenFunctions.from_numpy(_np_params(jm))
    cvec = [2, 0, 1]
    x = np.random.default_rng(1).standard_normal((10, 6)).astype(np.float32)
    y_j = np.asarray(jm.reordered(cvec)(jnp.asarray(x)))
    y_t = tm.reordered(cvec)(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(y_t, y_j, atol=1e-6)
    np.testing.assert_allclose(
        y_t, tm(torch.from_numpy(x)).detach().numpy()[:, cvec], atol=0
    )
    with pytest.raises(ValueError, match="permutation"):
        tm.reordered([0, 0, 1])


def test_init_is_seeded_and_in_bounds():
    a = EigenFunctions([9, 5, 1], 2, seed=7)
    b = EigenFunctions([9, 5, 1], 2, seed=7)
    c = EigenFunctions([9, 5, 1], 2, seed=8)
    for pa, pb, pc in zip(a.parameters(), b.parameters(), c.parameters()):
        assert torch.equal(pa, pb) and not torch.equal(pa, pc)
    assert a.weights[0].abs().max() <= 1 / 3  # U(+-1/sqrt(9))
    assert a.weights[0].shape == (2, 5, 9) and a.biases[1].shape == (2, 1)


def test_tanh_precise_matches_jax():
    x = np.concatenate([
        np.linspace(-30, 30, 2001), [0.0, 1e-8, -1e-8, 19.9, 20.1]
    ]).astype(np.float32)
    t = _tanh_precise(torch.from_numpy(x)).numpy()
    j = np.asarray(jax_tanh(jnp.asarray(x)))
    # same f32 formula in both libraries; exp may differ by an ulp
    np.testing.assert_allclose(t, j, atol=2e-7)
    np.testing.assert_allclose(t, np.tanh(x.astype(np.float64)), atol=3e-6)
    # the clip zeroes the gradient outside [-20, 20]
    xt = torch.tensor([-25.0, 0.0, 25.0], requires_grad=True)
    _tanh_precise(xt).sum().backward()
    assert xt.grad[0] == 0 and xt.grad[2] == 0 and xt.grad[1] == 1


def _split_heads(k, rows, replicas, seed):
    """float64 heads [4, 3, 3, 1] (stacked over ``replicas`` when given)
    and an input batch, all recording gradients."""
    gen = torch.Generator().manual_seed(seed)
    dims = [4, 3, 3, 1]
    lead = () if replicas is None else (replicas,)
    shapes = ([lead + (k, dims[i + 1], dims[i]) for i in range(3)]
              + [lead + (k, dims[i + 1]) for i in range(3)])
    params = [torch.randn(sh, generator=gen, dtype=torch.float64)
              .requires_grad_() for sh in shapes]
    x = torch.randn(rows, dims[0], generator=gen,
                    dtype=torch.float64).requires_grad_()
    return params, x


@pytest.mark.parametrize("k,rows,splits,replicas", [
    (1, 12, 3, None),  # a multiple of the chunks
    (2, 12, 4, None),
    (1, 13, 3, None),  # padded with zero rows
    (2, 11, 4, None),
    (2, 12, 3, 3),  # under torch.func.vmap over three replicas
    (2, 13, 4, 2),
])
def test_split_heads_product_equals_the_whole_product(k, rows, splits,
                                                      replicas):
    """The heads with every layer product split into chunks of the batch
    axis against the whole ``baddbmm``, in float64: values, first and second
    derivatives (the generator's double backward), and gradcheck and
    gradgradcheck of the split form."""
    params, x = _split_heads(k, rows, replicas, seed=10 * k + rows)

    def heads(s):
        def apply(x, *p):
            return _stacked_apply(p[:3], p[3:], x, "tanh", None, (s,) * 3)

        if replicas is None:
            return apply
        return lambda x, *p: torch.func.vmap(
            lambda *q: apply(x, *q))(*p)

    whole, split = heads(1), heads(splits)
    y = split(x, *params)
    assert y.shape == (() if replicas is None else (replicas,)) + (rows, k)
    torch.testing.assert_close(y, whole(x, *params), rtol=1e-13, atol=0)

    def derivatives(f):
        # the input gradient recorded, then differentiated to the weights
        out = f(x, *params)
        (g,) = torch.autograd.grad(out.sum(), x, create_graph=True)
        loss = (out ** 2).sum() + (g ** 2).sum()
        return torch.autograd.grad(loss, params)

    for a, b in zip(derivatives(split), derivatives(whole)):
        torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-14)
    assert torch.autograd.gradcheck(split, (x, *params))
    assert torch.autograd.gradgradcheck(split, (x, *params))


F32, BF16 = torch.float32, torch.bfloat16


@pytest.mark.parametrize("case", [
    # (device, records a weight gradient, rows, k or R k, result dtype):
    # the whole product
    ("cpu", True, 20_000, 2, F32),
    ("cuda", False, 20_000, 2, F32),  # no weight gradient recorded
    ("cuda", True, 2 * SPLIT_MIN_ROWS - 1, 2, F32),  # too few rows
    ("cuda", True, 20_000, 2, BF16),  # bf16 'pure': bfloat16 partials
    ("cuda", True, 20_000, 2, torch.float64),
    # split: k = 2 heads, and a sweep's R k = 128
    ("cuda", True, 20_000, 2, F32),
    ("cuda", True, 20_000, 128, F32),
    ("cuda", True, 2 * SPLIT_MIN_ROWS, 2, F32),
])
def test_split_count_rule(case):
    device, grad, rows, batch, dtype = case
    sms = 132  # an H100 SXM
    # the dipeptide's first layer, 20 x 30: one output tile a head
    s = split_count(device, grad, rows, batch, dtype, sms, 20, 30)
    if (device == "cpu" or not grad or dtype != F32
            or rows < 2 * SPLIT_MIN_ROWS):
        assert s == 1
    else:
        assert s > 1
        assert rows // s >= SPLIT_MIN_ROWS  # a few hundred rows a chunk
        # the card's SMs filled, unless the rows ran out first
        assert batch * s >= sms or s == rows // SPLIT_MIN_ROWS
        if rows == 20_000:
            assert batch * s >= sms
    # the same shapes asked again give the same answer: no state
    assert split_count(device, grad, rows, batch, dtype, sms, 20, 30) == s


def test_cpu_heads_keep_the_whole_product_and_count_it():
    """On the CPU every layer product is whole, grad mode or not, and the
    recorder counts each; under vmap the stacked weights show their
    replicas and that autograd records them."""
    model = EigenFunctions([5, 4, 4, 1], 2, seed=0)
    x = torch.randn(3 * SPLIT_MIN_ROWS, 5)
    logging_utils.reset_trace()
    want = model(x)
    with torch.no_grad():
        model(x)
    counted = logging_utils.counters()
    assert counted.get("cvf.heads.whole") == 6
    assert "cvf.heads.split" not in counted
    params = list(model.weights) + list(model.biases)
    torch.testing.assert_close(
        _stacked_apply(params[:3], params[3:], x, "tanh", None, (1,) * 3),
        want,
        rtol=0, atol=0)
    stacked = torch.stack([model.weights[0]] * 3).detach().requires_grad_()

    def peek(W):
        n, plain = _unwrapped(W)
        assert n == 3 and plain.requires_grad and plain.shape[0] == 3
        return W.sum()

    torch.func.vmap(peek)(stacked)
    assert _unwrapped(model.weights[0]) == (1, model.weights[0])
    with torch.no_grad():
        y = stacked_mlp_apply(list(model.weights), list(model.biases), x[0],
                              "tanh")
    # one row takes another f32 GEMM kernel than the batch
    torch.testing.assert_close(y, want[0], rtol=0, atol=1e-6)
    logging_utils.reset_trace()
