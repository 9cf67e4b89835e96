"""WideFormer and the Gemma-embedded MNIST in the port against the JAX
package on the CPU.

WideFormer: `tests/fixtures/wideformer_parity.yaml`'s network (hidden 64, 2
heads, 2 wide layers of width 2, the token mixers from 32 tokens back to
16) inside `flux.yaml`'s rectified-flow process, its CLIP and T5 hash
embedders at the fixture's widths (48 and 7 x 40): the token mixer against
flax's Conv, the forward, the loss and every parameter's gradient against
jitted `jax.value_and_grad`, a 10-step guided trajectory (the MM-DiT
file's checks and tolerances), the reference-checkpoint import against
JAX's through the weight bridge, and the importer's dispatcher.

The Gemma-embedded MNIST: the hash prompt embeddings bit for bit,
`embeddings_for` with a seeded generator, the `embeddings.npz` path from a
temporary file, and the dataset registry."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from test_torch_port_common import no_transformers, one_torch_thread  # noqa: F401 (autouse)
from test_torch_port_dit import _flat, _tree

import test_torch_port_mmdit as mm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests/fixtures/wideformer_parity.yaml")
NAME = "wideformer"


def wideformer_config(directory) -> str:
    """flux.yaml's process around the fixture's network, the embedders at
    its widths (pooled 48, 7 tokens of 40); written to `directory`."""
    with open(mm.config_path("flux")) as f:
        cfg = yaml.safe_load(f)
    with open(FIXTURE) as f:
        net = yaml.safe_load(f)["diffusion"]["score_network"]
    p = net["params"]
    p.update(input_channels=1, output_channels=1, is_learned_sigma=False,
             is_class_conditional=False)
    clip, t5 = cfg["diffusion"]["context_preprocessing"]
    clip["params"]["embedding_dim"] = p["vec_in_dim"]
    t5["params"].update(embedding_dim=p["context_in_dim"], max_length=p["max_text_tokens"])
    cfg["diffusion"]["score_network"] = net
    path = os.path.join(str(directory), "wideformer.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    """The JAX and port processes on shared seeded weights, registered in
    the MM-DiT file's cache under NAME so its checks run on them."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import load_flax_params, random_flax_params

    path = wideformer_config(tmp_path_factory.mktemp("wideformer"))
    jmodel = JaxDDPM(jax_load_yaml(path))
    mm.offline(jmodel._context_preprocessors)
    x, ctx = jmodel.example_batch(2)
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    drawn = random_flax_params(_flat(shapes["params"]), seed=7)
    pmodel = GaussianDiffusion_DDPM(load_yaml(path), device="cpu")
    load_flax_params(pmodel.score_network(), drawn)
    mm._BUILT[NAME] = jmodel, {"params": _tree(drawn)}, pmodel, drawn
    yield path
    mm._BUILT.pop(NAME, None)


def test_token_mixer_is_flax_conv_over_features(built):
    """flax Conv over (B, D, L_in), kernel (3, L_in, L_out), padding SAME,
    is the port's Conv1d(L_in, L_out, 3, padding=1) on (B, L_in, D)."""
    from flax import linen as nn

    from xdiffusion_tpu_torch.weights import load_flax_params

    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 32, 64)).astype(np.float32)
    conv = nn.Conv(features=16, kernel_size=(3,), padding="SAME")
    params = {"params": {"kernel": jnp.asarray(rng.standard_normal((3, 32, 16)), jnp.float32),
                         "bias": jnp.asarray(rng.standard_normal(16), jnp.float32)}}
    want = np.asarray(conv.apply(params, jnp.asarray(x).transpose(0, 2, 1))).transpose(0, 2, 1)
    mixer = mm._BUILT[NAME][2].score_network().layer1_block0.token_mixer
    port = torch.nn.Conv1d(32, 16, 3, padding=1)
    assert (mixer.in_channels, mixer.out_channels, mixer.kernel_size) == (32, 16, (3,))
    load_flax_params(port, {k: np.asarray(v) for k, v in params["params"].items()})
    with torch.no_grad():
        got = port(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_wideformer_forward_matches_jax(built):
    mm.check_forward(NAME)


def test_wideformer_loss_and_every_gradient_match_jax(built, monkeypatch):
    """The MM-DiT file's loss and gradient check. Every block's text stream
    output is dropped, in JAX too, so the text half after the attention
    (`txt_proj`, `txt_mlp1`, `txt_mlp2`) takes no gradient: JAX's is exactly
    zero there, the port's None, checked as zeros. A token mixer's bias
    gradient sums the output's gradient over the batch and 64 features for
    each of its 16 tokens, terms that cancel: 3e-4 of its scale there (1.3e-4
    measured), GRAD_TOL elsewhere."""
    import test_torch_port_dit as dit

    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    unused = []

    def with_unused_zeros(grads, net):
        want = flax_to_state_dict({k: np.asarray(v) for k, v in _flat(grads["params"]).items()},
                                  net)
        for name, p in net.named_parameters():
            if p.grad is None:
                assert not want[name].any(), name
                unused.append(name)
                p.grad = torch.zeros_like(p)
        errors = dit._grad_errors(grads, net)
        biases.update({n: errors.pop(n) for n in list(errors) if n.endswith("mixer.bias")})
        return errors

    biases = {}
    monkeypatch.setattr(mm, "_grad_errors", with_unused_zeros)
    mm.check_loss_and_gradients(NAME)
    assert len(biases) == 3 and max(biases.values()) <= 3e-4, biases
    assert unused and all(n.split(".")[2].split("_")[0] == "txt" and
                          n.split(".")[2] in ("txt_proj", "txt_mlp1", "txt_mlp2")
                          for n in unused), unused


def test_wideformer_guided_ten_step_trajectory_matches_jax(built):
    mm.check_trajectory(NAME, steps=10)


def test_wideformer_structure_and_attention_calls(built, monkeypatch):
    """depth x width blocks and the final block, a token mixer wherever the
    incoming sequence is width * L tokens; one attention (K5 on the card)
    per block: depth * width + 1 = 5 a forward."""
    from xdiffusion_tpu_torch.layers import flux

    pmodel = mm._BUILT[NAME][2]
    net = pmodel.score_network()
    names = sorted(n for n, _ in net.named_children() if "block" in n)
    assert names == ["final_block", "layer0_block0", "layer0_block1", "layer1_block0",
                     "layer1_block1"]
    assert net.layer0_block0.token_mixer is None and net.final_block.token_mixer is not None
    calls = []
    original = flux.rope_attention
    monkeypatch.setattr(flux, "rope_attention",
                        lambda q, *a: calls.append(tuple(q.shape)) or original(q, *a))
    jctx, pctx = mm.contexts(mm._BUILT[NAME][0], pmodel)
    pctx["timestep"] = torch.full((2,), 0.5)
    with torch.inference_mode():
        pmodel.predict_score(torch.zeros(mm.image_shape(pmodel)), pctx)
    assert calls == [(2, 2, 7 + 16, 32)] * 5


def test_wideformer_import_equals_the_bridged_jax_import(built, monkeypatch):
    """A reference-layout file of seeded port parameters (the resolvers'
    inverses) is taken by the JAX importer, strict; the port's import equals
    it through the bridge bit for bit and gives back the seeded parameters."""
    from test_torch_port_importers import (
        _assert_equal_states, _bridge, _jax_zeros, _scramble, _seeded, reference_layout)
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM
    from xdiffusion_tpu.importers import import_score_network_params as jax_import

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.importers.torch_state_dict import import_score_network_params

    config = load_yaml(built)
    net = GaussianDiffusion_DDPM(config, device="cpu").score_network()
    seeded = _seeded(net)
    sd = reference_layout(net, lambda m, s: import_score_network_params(config, m, s),
                          monkeypatch)
    assert any(k.endswith("._token_mixer.weight") for k in sd)
    jconfig = jax_load_yaml(built)
    jtree = jax_import(jconfig, _jax_zeros(JaxDDPM(jconfig), {}), sd, strict=True)
    want = _bridge(jtree, net)
    _scramble(net)
    import_score_network_params(config, net, {k: torch.from_numpy(v) for k, v in sd.items()})
    got = net.state_dict()
    _assert_equal_states({k: got[k] for k in want}, want)
    _assert_equal_states(got, seeded)
    del sd["transformer_final._token_mixer.bias"]
    with pytest.raises(KeyError, match="_token_mixer.bias"):
        import_score_network_params(config, net, sd)


# ---- the Gemma-embedded MNIST ----------------------------------------------------


def test_gemma_hash_embeddings_are_bit_equal_to_jax(tmp_path, monkeypatch):
    """No embeddings.npz: the (10, 2, 300, 2304) hash embeddings of the 20
    prompts bit for bit; the images and labels are MNIST's."""
    from xdiffusion_tpu.datasets.mnist_embedded_gemma_2 import MNISTEmbeddedGemma2 as JaxGemma

    from xdiffusion_tpu_torch.datasets.mnist_embedded_gemma_2 import MNISTEmbeddedGemma2

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path))
    jax_ds = JaxGemma(num_synthetic=60)
    ds = MNISTEmbeddedGemma2(num_synthetic=60)
    assert ds.synthetic_embeddings and jax_ds.synthetic_embeddings
    assert ds.prompt_embeddings.shape == (10, 2, 300, 2304)
    assert ds.prompt_embeddings.dtype == np.float32
    np.testing.assert_array_equal(ds.prompt_embeddings, jax_ds.prompt_embeddings)
    np.testing.assert_array_equal(ds.images, jax_ds.images)
    np.testing.assert_array_equal(ds.labels, jax_ds.labels)
    labels = np.array([0, 9, 3, 3, 7])
    got = ds.embeddings_for(labels, rng=np.random.default_rng(4))
    want = jax_ds.embeddings_for(labels, rng=np.random.default_rng(4))
    assert got.shape == (5, 300, 2304)
    np.testing.assert_array_equal(got, want)


def test_gemma_embeddings_npz_path(tmp_path, monkeypatch):
    """With {data_root}/mnist_gemma2/embeddings.npz both packages read its
    (10, 2, 300, 2304) table as fp32 and gather from it alike."""
    from xdiffusion_tpu.datasets.mnist_embedded_gemma_2 import MNISTEmbeddedGemma2 as JaxGemma

    from xdiffusion_tpu_torch.datasets.mnist_embedded_gemma_2 import MNISTEmbeddedGemma2

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path))
    (tmp_path / "mnist_gemma2").mkdir()
    table = np.random.default_rng(1).standard_normal((10, 2, 300, 2304)).astype(np.float16)
    np.savez(tmp_path / "mnist_gemma2" / "embeddings.npz", embeddings=table)
    ds, jax_ds = MNISTEmbeddedGemma2(num_synthetic=60), JaxGemma(num_synthetic=60)
    assert not ds.synthetic_embeddings
    assert ds.prompt_embeddings.dtype == np.float32
    np.testing.assert_array_equal(ds.prompt_embeddings, table.astype(np.float32))
    np.testing.assert_array_equal(ds.prompt_embeddings, jax_ds.prompt_embeddings)
    labels = np.arange(10)
    np.testing.assert_array_equal(ds.embeddings_for(labels, rng=np.random.default_rng(2)),
                                  jax_ds.embeddings_for(labels, rng=np.random.default_rng(2)))


def test_gemma_dataset_is_in_the_registry(tmp_path, monkeypatch):
    from xdiffusion_tpu_torch.datasets import mnist
    from xdiffusion_tpu_torch.datasets.mnist_embedded_gemma_2 import MNISTEmbeddedGemma2
    from xdiffusion_tpu_torch.datasets.utils import load_dataset

    monkeypatch.setenv("XDIFFUSION_DATA_DIR", str(tmp_path))
    monkeypatch.setattr(mnist.MNIST.__init__, "__defaults__", (
        "train", 32, False, 60))
    ds, prompts = load_dataset("image/mnist_embedded_gemma_2")
    assert isinstance(ds, MNISTEmbeddedGemma2) and len(ds) == 60
    assert prompts(np.array([3]), rng=np.random.default_rng(0))[0] in ("three", "3")
