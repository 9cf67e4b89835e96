"""The port's config reader, import isolation, device policy, weight bridge
and sampling CLI, on the CPU."""

import glob
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
from test_torch_port_common import one_torch_thread  # noqa: F401 (autouse)
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "configs/image/mnist/ddpm_32x32_epsilon_discrete.yaml")
IMAGE_CONFIGS = sorted(glob.glob(os.path.join(REPO, "configs/image/**/*.yaml"), recursive=True))


@pytest.mark.parametrize("path", IMAGE_CONFIGS, ids=lambda p: os.path.relpath(p, REPO))
def test_load_yaml_matches_safe_load_and_jax(path):
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml

    from xdiffusion_tpu_torch.config import load_yaml

    with open(path) as f:
        want = yaml.safe_load(f)
    assert load_yaml(path).to_dict() == want == jax_load_yaml(path).to_dict()


def test_flagship_targets_resolve_into_the_port():
    from xdiffusion_tpu_torch.config import get_obj_from_str, load_yaml

    targets = []

    def walk(node):
        if isinstance(node, dict):
            if "target" in node:
                targets.append(node["target"])
            for v in node.values():
                walk(v)
        elif isinstance(node, list):
            for v in node:
                walk(v)

    walk(load_yaml(FLAGSHIP).to_dict())
    walk(load_yaml(os.path.join(REPO, "configs/image/mnist/samplers/ddim.yaml")).to_dict())
    assert len(targets) >= 10
    for t in targets:
        obj = get_obj_from_str(t)
        assert obj.__module__.startswith("xdiffusion_tpu_torch."), (t, obj.__module__)


def test_port_imports_no_jax_and_no_jax_package():
    """Every module of the port, and chip_smoke.py, imports with jax, flax and
    xdiffusion_tpu blocked; a CPU sampling step and a training step then run
    without them."""
    script = textwrap.dedent(f"""
        import importlib, pkgutil, sys
        BLOCKED = ("jax", "jaxlib", "flax", "optax", "xdiffusion_tpu")

        class Block:
            def find_spec(self, name, path=None, target=None):
                if name.split(".")[0] in BLOCKED:
                    raise ImportError("blocked " + name)
                return None

        sys.meta_path.insert(0, Block())
        sys.path.insert(0, {REPO!r})
        import xdiffusion_tpu_torch
        for m in pkgutil.walk_packages(xdiffusion_tpu_torch.__path__, "xdiffusion_tpu_torch."):
            importlib.import_module(m.name)
        import chip_smoke
        from xdiffusion_tpu_torch.config import load_yaml
        from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
        cfg = load_yaml({FLAGSHIP!r})
        sn = cfg.diffusion.score_network.params.to_dict()
        sn["num_features"] = 32
        sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
        model = GaussianDiffusion_DDPM(cfg, device="cpu")
        model.sample(num_samples=1, num_sampling_steps=1)
        import torch
        from xdiffusion_tpu_torch.optim import default_optimizer
        from xdiffusion_tpu_torch.train_step import create_train_state, make_train_step
        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()))
        make_train_step(model)(state, {{"images": torch.rand(1, 32, 32, 1)}})
        bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
        assert not bad, bad
        print("isolated")
    """)
    out = subprocess.run([sys.executable, "-c", script], capture_output=True, text=True,
                         timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stderr[-3000:]
    assert "isolated" in out.stdout


def test_entry_points_raise_without_cuda_unless_cpu_is_asked(monkeypatch, tmp_path):
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.utils import resolve_device

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GaussianDiffusion_DDPM(load_yaml(FLAGSHIP))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["--config_path", FLAGSHIP, "--checkpoint", str(tmp_path / "none.pt")])
    assert resolve_device("cpu") == torch.device("cpu")


def _small_config_file(tmp_path):
    with open(FLAGSHIP) as f:
        cfg = yaml.safe_load(f)
    sn = cfg["diffusion"]["score_network"]["params"]
    sn["num_features"] = 32
    sn["conditioning"]["projections"]["timestep"]["params"]["num_features"] = 32
    path = tmp_path / "small.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


def test_sample_cli_on_cpu_writes_a_png_grid(tmp_path):
    from PIL import Image

    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.weights import randomize_

    config = _small_config_file(tmp_path)
    model = GaussianDiffusion_DDPM(load_yaml(config), device="cpu")
    randomize_(model.score_network(), 3)
    ckpt = tmp_path / "weights.pt"
    torch.save(model.score_network().state_dict(), ckpt)
    out_dir = tmp_path / "out"
    samples = cli.main([
        "--config_path", config, "--checkpoint", str(ckpt), "--num_samples", "3",
        "--sampling_steps", "2", "--sampler_config_path",
        os.path.join(REPO, "configs/image/mnist/samplers/ddim.yaml"),
        "--output_path", str(out_dir), "--seed", "5", "--device", "cpu",
    ])
    assert samples.shape == (3, 32, 32, 1)
    img = np.asarray(Image.open(out_dir / "sample-step0.png"))  # a state dict has no step
    assert img.shape == (64, 64)  # 2 x 2 grid of 32 x 32
    want = (np.clip(samples.numpy()[0, ..., 0], 0, 1) * 255).astype(np.uint8)
    np.testing.assert_array_equal(img[:32, :32], want)
    np.testing.assert_array_equal(img[32:, 32:], 0)  # the empty fourth cell


def test_sample_cli_names_the_png_by_checkpoint_step_and_refuses_lora_and_prompts(tmp_path):
    """As sampling/image/sample.py: the grid is `sample-step{step}.png` with
    the step a training checkpoint records; `--lora_weights` (`--lora_path`)
    merges a lora_weights.pkl into the restored parameters before sampling:
    the samples equal the merged network's (the name keeps the time before
    LoRA was ported, when it refused them). `--text_prompts` is ported: an
    unconditional config (the flagship's) leaves the prompts unused, as JAX
    does, and samples as without them."""
    from xdiffusion_tpu_torch import lora as lora_lib
    from xdiffusion_tpu_torch import sample as cli
    from xdiffusion_tpu_torch.checkpoints import save_checkpoint
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state
    from xdiffusion_tpu_torch.weights import randomize_

    config = _small_config_file(tmp_path)
    model = GaussianDiffusion_DDPM(load_yaml(config), device="cpu")
    randomize_(model.score_network(), 3)
    state = create_train_state(model, default_optimizer().build(
        model.score_network().parameters()))
    ckpt = save_checkpoint(str(tmp_path / "checkpoints"), state, 17)
    common = ["--config_path", config, "--checkpoint", ckpt, "--num_samples", "1",
              "--sampling_steps", "1", "--output_path", str(tmp_path / "out"),
              "--device", "cpu"]
    plain = cli.main(common)
    assert sorted(os.listdir(tmp_path / "out")) == ["sample-step17.png"]
    net = model.score_network()
    lora = lora_lib.inject_trainable_lora(net, torch.Generator().manual_seed(1), r=2)
    with torch.no_grad():
        for up in lora.up:
            up.normal_(std=0.1, generator=torch.Generator().manual_seed(2))
    lora_file = str(tmp_path / "lora_weights.pkl")
    lora_lib.save_lora_weights(lora, lora_file)
    lora_lib.merge_lora(net, lora)
    merged = model.sample(num_samples=1, num_sampling_steps=1,
                          generator=torch.Generator().manual_seed(0))
    assert not torch.equal(merged, plain)
    for flag in ("--lora_weights", "--lora_path"):
        torch.testing.assert_close(cli.main(common + [flag, lora_file]), merged, rtol=0, atol=0)
    prompted = cli.main(common + ["--text_prompts", "a digit, another"])
    torch.testing.assert_close(prompted, plain, rtol=0, atol=0)


def test_guidance_with_the_identity_unconditional_context(tmp_path):
    """The flagship's unconditional context is `torch.nn.Identity` (the
    context itself), so guidance runs the 2x batch and mixes two equal
    predictions: the samples equal unguided ones."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.samplers.ddim import DDIMSampler
    from xdiffusion_tpu_torch.weights import randomize_

    model = GaussianDiffusion_DDPM(load_yaml(_small_config_file(tmp_path)), device="cpu")
    randomize_(model.score_network(), 4)
    init = torch.randn(2, 32, 32, 1, generator=torch.Generator().manual_seed(0))
    runs = [model.sample(num_samples=2, num_sampling_steps=3, sampler=DDIMSampler(),
                         initial_noise=init, classifier_free_guidance=g)
            for g in (None, 3.0)]
    torch.testing.assert_close(runs[0], runs[1], atol=1e-5, rtol=0)


def test_png_grid_rgb_roundtrip(tmp_path):
    from PIL import Image

    from xdiffusion_tpu_torch.sample import save_image_grid

    x = np.random.default_rng(0).random((2, 5, 7, 3)).astype(np.float32)
    save_image_grid(x, str(tmp_path / "g.png"), cols=2)
    img = np.asarray(Image.open(tmp_path / "g.png"))
    assert img.shape == (5, 14, 3)
    np.testing.assert_array_equal(img[:, 7:], (x[1] * 255).astype(np.uint8))


def test_weight_bridge_layouts_and_npz_checkpoint(tmp_path):
    """Dense (I, O) -> (O, I); Conv HWIO -> OIHW for F.conv2d convs; the
    residual block's K4 convs keep HWIO; an .npz of flax paths loads."""
    import jax
    from flax import traverse_util
    from xdiffusion_tpu.layers.resnet import ResnetBlockBigGAN as JaxBlock

    from xdiffusion_tpu_torch.layers.resnet import ResnetBlockBigGAN
    from xdiffusion_tpu_torch.weights import (
        flax_to_state_dict,
        load_checkpoint,
        random_flax_params,
    )

    x = jax.numpy.zeros((1, 4, 4, 32))
    ctx = {"timestep_embedding": jax.numpy.zeros((1, 16))}
    init = JaxBlock(dim_out=64).init(jax.random.PRNGKey(0), x, ctx)
    flat = random_flax_params(
        {"/".join(k): v for k, v in traverse_util.flatten_dict(init["params"]).items()}, 1)
    port = ResnetBlockBigGAN(32, 64, 16)
    sd = flax_to_state_dict(flat, port)
    np.testing.assert_array_equal(sd["emb_proj.weight"].numpy(), flat["emb_proj/kernel"].T)
    np.testing.assert_array_equal(sd["skip.weight"].numpy(),
                                  flat["skip/kernel"].transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(sd["conv1.kernel"].numpy(), flat["conv1/kernel"])
    np.testing.assert_array_equal(sd["norm2.scale"].numpy(), flat["norm2/scale"])
    np.savez(tmp_path / "params.npz", **flat)
    load_checkpoint(port, str(tmp_path / "params.npz"))
    for k, v in port.state_dict().items():
        torch.testing.assert_close(v, sd[k], atol=0.0, rtol=0.0)
    with pytest.raises(KeyError):
        flax_to_state_dict({**flat, "extra/kernel": np.zeros((2, 2))}, port)
    with pytest.raises(KeyError):
        flax_to_state_dict({k: v for k, v in flat.items() if k != "conv2/bias"}, port)
