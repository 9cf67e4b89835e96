"""The reference-checkpoint importers, the UNet exporter and the import CLI of
the port against the JAX package on the CPU.

No reference (PyTorch) network is at hand, so each family's reference-layout
state dict is written from seeded port parameters through the inverse of
every layout transform of the port's resolver (a transpose's transpose, a
reshape's reshape, the per-head qkv interleave, a concatenation's split):
`reference_layout`. The JAX importer, run strict, must take that file
without a missing key or a shape error, and the port's import must equal the
JAX import passed through the weight bridge bit for bit, and give back the
seeded parameters bit for bit. The JAX parameter trees come from
`jax.eval_shape`: nothing is compiled.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch
import yaml
from flax import traverse_util
from test_torch_port_common import no_transformers, one_torch_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = os.path.join(REPO, "configs")
FIXTURES = os.path.join(REPO, "tests", "fixtures")
FLAGSHIP = os.path.join(CONFIGS, "image/mnist/ddpm_32x32_epsilon_discrete.yaml")


def _load(path):
    with open(path) as f:
        return yaml.safe_load(f)


def _write(cfg, directory, name):
    path = os.path.join(str(directory), name + ".yaml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path


def _image_process(fixture, directory):
    """The flagship's process around an image fixture's network, its sizes."""
    cfg = _load(FLAGSHIP)
    net = _load(os.path.join(FIXTURES, fixture + ".yaml"))["diffusion"]["score_network"]
    size = net["params"]["input_spatial_size"]
    cfg["diffusion"]["score_network"] = net
    cfg["diffusion"]["sampling"]["output_spatial_size"] = size
    cfg["data"]["image_size"] = size
    return _write(cfg, directory, fixture)


def _flagship(directory):
    from test_torch_port_train import tiny_config

    return tiny_config(os.path.join(str(directory), "flagship.yaml"))


def _video(fixture):
    def make(directory):
        from test_torch_port_video_unet import video_config

        return video_config(fixture, directory)

    return make


def _fdm(directory):
    from test_torch_port_fdm import fdm_config

    return fdm_config(directory)


def _shipped(relative, cut):
    def make(directory):
        cfg = _load(os.path.join(CONFIGS, relative))
        cut(cfg)
        return _write(cfg, directory, os.path.basename(relative)[:-5])

    return make


def _dict(builder):
    def make(directory):
        return _write(builder(), directory, builder.__name__)

    return make


def _mmdit(name):
    def make(directory):
        from test_torch_port_mmdit import TINY, config_path

        cfg = _load(config_path(name))
        cfg["diffusion"]["score_network"]["params"].update(TINY[name])
        if "input_spatial_size" in TINY[name]:
            cfg["diffusion"]["sampling"]["output_spatial_size"] = TINY[name]["input_spatial_size"]
        return _write(cfg, directory, name)

    return make


def _dit(directory):
    from test_torch_port_dit import tiny_config

    return _write(tiny_config(), directory, "dit")


def _pixart(directory):
    from test_torch_port_pixart import _tiny_pixart

    return _tiny_pixart(os.path.join(str(directory), "pixart.yaml"))


def _sana(directory):
    from test_torch_port_sana import _tiny_config_file

    import pathlib

    return _tiny_config_file(pathlib.Path(directory))


def _ltx(cfg):
    from test_torch_port_ltx import _small_config

    _small_config(cfg)


def _sora():
    from test_torch_port_sora import tiny_sora

    return tiny_sora()


def _hunyuan():
    from test_torch_port_hunyuan import tiny_hunyuan_video

    return tiny_hunyuan_video()


# Integer context the JAX init needs beyond its example batch: name -> the
# shape of one example's.
TEXT = {"text_tokens": (6,)}
CLASSES = {"classes": ()}

# family -> (config writer, extra JAX init context)
FAMILIES = {
    "unet": (_flagship, {}),
    "unet_3d": (_video("video_trajectory_parity"), {}),
    "unet_pseudo3d": (_video("make_a_video_parity"), TEXT),
    "fdm": (_fdm, {}),
    "animate_diff": (_video("animate_diff_parity"), TEXT),
    "video_ldm": (_video("video_ldm_parity"), TEXT),
    "dit": (_dit, {}),
    "pixart": (_pixart, {}),
    "dyt": (lambda d: _image_process("dyt_parity", d), CLASSES),
    "sd3": (_mmdit("sd3"), {}),
    "sd3.5": (_mmdit("sd3.5"), {}),
    "flux": (_mmdit("flux"), {}),
    "flux_dyt": (_mmdit("flux_dyt"), {}),
    "chewie": (_mmdit("chewie"), {}),
    "auraflow": (_mmdit("auraflow"), {}),
    "diffussm": (_mmdit("diffussm"), {}),
    "sana": (_sana, {}),
    "efficient_unet": (lambda d: _image_process("efficient_unet_parity", d), TEXT),
    "sora": (_dict(_sora), {}),
    "ltx_video": (_shipped("video/moving_mnist/ltx_video/ltx_video_pixel_space.yaml", _ltx), {}),
    "hunyuan_video": (_dict(_hunyuan), {}),
}


def _jax_zeros(jmodel, extra):
    """The JAX score network's parameter tree, zeros of `jax.eval_shape`'s
    shapes."""
    import jax.numpy as jnp
    from test_torch_port_mmdit import offline

    offline(jmodel._context_preprocessors)
    x, ctx = jmodel.example_batch(2)
    ctx.update({name: jnp.zeros((2,) + shape, jnp.int32) for name, shape in extra.items()})
    shapes = jax.eval_shape(jmodel._score_network.init, jax.random.PRNGKey(0), x, ctx)
    return jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype),
                                  {"params": shapes["params"]})


def reference_layout(module, run_import, monkeypatch, hints=()):
    """A reference-layout state dict of `module`'s parameters: each flax leaf
    (weights.state_dict_to_flax) through the inverse of the layout transform
    the port's resolver gives it. `run_import(module, sd)` runs the port's
    importer; its resolver is captured at `_apply_mapping`. The resolver
    probes `sd` for dialect markers (which key names a tensor), so the keys
    are written again with the previous pass's keys (and `hints`) in `sd`
    until they stop changing. Every leaf must resolve."""
    from xdiffusion_tpu_torch.importers import autoencoders, torch_state_dict as tsd
    from xdiffusion_tpu_torch.weights import state_dict_to_flax

    captured = {}

    def capture(module, sd, resolve, strict=True):
        captured["resolve"] = resolve
        return module

    flat = state_dict_to_flax(module)
    keys = set(hints)
    with monkeypatch.context() as m:
        m.setattr(tsd, "_apply_mapping", capture)
        m.setattr(autoencoders, "_apply_mapping", capture)
        for _ in range(4):
            run_import(module, {k: None for k in sorted(keys)})
            out = {}
            for path, value in flat.items():
                found = captured["resolve"](tuple(path.split("/")))
                assert found is not None, f"{path} has no reference key"
                key, tf = found
                if key is tsd.MULTI:
                    tf.inv(value, out)
                else:
                    assert key not in out, f"{key} written twice"
                    out[key] = np.ascontiguousarray(tf.inv(value))
            if set(out) | set(hints) == keys:
                return out
            keys = set(out) | set(hints)
    raise AssertionError("the reference keys did not settle")


def _context_head_hints(net):
    """PixArt's resolver pairs the k-th parameterised context head with the
    k-th reference `_context_transformers.<i>.y_proj` by position: one key
    of each, at the flax head's own index."""
    from xdiffusion_tpu_torch.weights import flax_paths

    heads = {p.split("/")[0].rpartition("_")[2] for p in flax_paths(net).values()
             if p.startswith("_context_heads_")}
    return {f"_context_transformers.{i}.y_proj.fc1.weight" for i in heads}


def _bridge(jax_tree, module):
    """The JAX tree through weights.py's bridge, each tensor in its port
    parameter's shape (the bridge hands a 0-d leaf over as (1,), which
    load_state_dict takes)."""
    from xdiffusion_tpu_torch.weights import flax_to_state_dict

    flat = traverse_util.flatten_dict(jax_tree)
    target = module.state_dict()
    return {k: v.reshape(target[k].shape) for k, v in flax_to_state_dict(
        {"/".join(k[1:] if k[0] == "params" else k): np.asarray(v) for k, v in flat.items()},
        module).items()}


def _assert_equal_states(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


def _seeded(net, seed=5):
    from xdiffusion_tpu_torch.weights import randomize_

    randomize_(net, seed)
    return {k: v.clone() for k, v in net.state_dict().items()}


def _scramble(net):
    with torch.no_grad():
        for p in net.parameters():
            p.fill_(7.0)


@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_score_network_import_equals_the_bridged_jax_import(family, tmp_path, monkeypatch):
    """Per family: the reference-layout file of seeded port parameters is
    taken by the JAX importer (strict: no missing key, every shape right);
    the port's import equals the JAX import through weights.py's bridge bit
    for bit and gives back the seeded parameters bit for bit."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM
    from xdiffusion_tpu.importers import import_score_network_params as jax_import

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.importers.torch_state_dict import import_score_network_params

    make, extra = FAMILIES[family]
    path = make(tmp_path)
    config = load_yaml(path)
    net = GaussianDiffusion_DDPM(config, device="cpu").score_network()
    seeded = _seeded(net)
    sd = reference_layout(net, lambda m, s: import_score_network_params(config, m, s),
                          monkeypatch, _context_head_hints(net))

    jconfig = jax_load_yaml(path)
    jtree = jax_import(jconfig, _jax_zeros(JaxDDPM(jconfig), extra), sd, strict=True)
    want = _bridge(jtree, net)
    _scramble(net)
    import_score_network_params(config, net, {k: torch.from_numpy(v) for k, v in sd.items()})
    got = net.state_dict()
    _assert_equal_states({k: got[k] for k in want}, want)
    _assert_equal_states({k: got[k] for k in seeded}, seeded)


# ---- autoencoders --------------------------------------------------------------


def _kl():
    return _load(os.path.join(FIXTURES, "vae_import_cli.yaml"))["autoencoder"]


def _ltx_vae():
    from test_torch_port_causal_vae import tiny_ltx

    return tiny_ltx()


def _hunyuan_vae():
    from test_torch_port_causal_vae import tiny_hunyuan

    return tiny_hunyuan()


VAES = {"kl": _kl, "ltx_vae": _ltx_vae, "hunyuan_vae": _hunyuan_vae}


@pytest.mark.parametrize("family", sorted(VAES))
def test_autoencoder_import_equals_the_bridged_jax_import(family, monkeypatch):
    """The KL, LTX and Hunyuan VAE importers as the score networks': the
    JAX importer takes the file strictly, and the port's import of the
    autoencoder's `ae` equals the bridged JAX import and the seeded
    parameters, bit for bit."""
    import copy

    from xdiffusion_tpu.config import instantiate_from_config as jax_instantiate
    from xdiffusion_tpu.importers import autoencoders as jax_ae

    from xdiffusion_tpu_torch.config import instantiate_from_config
    from xdiffusion_tpu_torch.importers import autoencoders

    cfg = VAES[family]()
    name = {"kl": "import_autoencoder_kl_params", "ltx_vae": "import_ltx_vae_params",
            "hunyuan_vae": "import_hunyuan_vae_params"}[family]
    vae = instantiate_from_config(copy.deepcopy(cfg), use_config_struct=True, device="cpu")
    seeded = _seeded(vae.ae)
    sd = reference_layout(vae.ae, getattr(autoencoders, name), monkeypatch)

    jvae = jax_instantiate(copy.deepcopy(cfg), use_config_struct=True)
    shapes = jax.eval_shape(jvae.init_params, jax.random.PRNGKey(0))["ae"]
    zeros = jax.tree_util.tree_map(lambda s: np.zeros(s.shape, s.dtype), shapes)
    want = _bridge(getattr(jax_ae, name)(zeros, sd, strict=True), vae.ae)
    _scramble(vae.ae)
    getattr(autoencoders, name)(vae.ae, {k: torch.from_numpy(v) for k, v in sd.items()})
    got = vae.ae.state_dict()
    _assert_equal_states({k: got[k] for k in want}, want)
    _assert_equal_states({k: got[k] for k in seeded}, seeded)


# ---- the dispatcher's other branches ------------------------------------------------


def test_precond_branch_goes_to_the_edm_importer():
    """An EDM preconditioner's reference state dict (its backbone under
    "model.") goes to importers/edm.py: the same backbone as its own
    importer gives."""
    from test_torch_port_edm import _config, _reference_state_dict

    from xdiffusion_tpu_torch.config import DotConfig
    from xdiffusion_tpu_torch.importers.edm import import_edm_unet_params
    from xdiffusion_tpu_torch.importers.torch_state_dict import import_score_network_params
    from xdiffusion_tpu_torch.training.image.train import build_model

    config = DotConfig(_config())
    net = build_model(config, device="cpu").score_network()
    sd = _reference_state_dict(net.model, seed=9, song_head=True)
    import_score_network_params(config, net, {"model." + k: v for k, v in sd.items()})
    other = build_model(config, device="cpu").score_network()
    import_edm_unet_params(other.model, sd, arch="song")
    _assert_equal_states(net.state_dict(), other.state_dict())


def test_strict_import_names_every_missing_key_and_shape_errors(tmp_path, monkeypatch):
    """Strict: a KeyError that lists each missing parameter with its
    reference key; not strict, the parameter keeps its value; a tensor of
    the wrong shape is a ValueError naming both."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.importers.torch_state_dict import import_score_network_params

    path = _flagship(tmp_path)
    config = load_yaml(path)
    net = GaussianDiffusion_DDPM(config, device="cpu").score_network()
    seeded = _seeded(net)
    sd = reference_layout(net, lambda m, s: import_score_network_params(config, m, s),
                          monkeypatch)
    partial = {k: v for k, v in sd.items() if k != "final_projection.2.weight"}
    with pytest.raises(KeyError, match=r"final_conv/kernel <- final_projection\.2\.weight"):
        import_score_network_params(config, net, partial)
    _scramble(net)
    import_score_network_params(config, net, partial, strict=False)
    got = net.state_dict()
    assert torch.all(got["final_conv.weight"] == 7.0)
    _assert_equal_states({k: got[k] for k in seeded if k != "final_conv.weight"},
                         {k: v for k, v in seeded.items() if k != "final_conv.weight"})
    bad = dict(sd, **{"final_projection.2.weight": sd["final_projection.2.weight"][:, :, :2]})
    with pytest.raises(ValueError, match="final_projection.2.weight -> final_conv/kernel"):
        import_score_network_params(config, net, bad)


# ---- the exporter -------------------------------------------------------------------


def test_unet_export_equals_jax_and_round_trips(tmp_path):
    """export_unet_params of the seeded tiny flagship equals JAX's on the
    same weights (key for key, bit for bit), JAX's importer takes it
    strictly, and the port's import of it gives the parameters back bit for
    bit."""
    from xdiffusion_tpu.config import load_yaml as jax_load_yaml
    from xdiffusion_tpu.diffusion.ddpm import GaussianDiffusion_DDPM as JaxDDPM
    from xdiffusion_tpu.importers import import_score_network_params as jax_import
    from xdiffusion_tpu.importers.export_torch import export_unet_params as jax_export

    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.importers.export_torch import export_unet_params
    from xdiffusion_tpu_torch.importers.torch_state_dict import import_score_network_params
    from xdiffusion_tpu_torch.weights import state_dict_to_flax

    path = _flagship(tmp_path)
    config = load_yaml(path)
    net = GaussianDiffusion_DDPM(config, device="cpu").score_network()
    seeded = _seeded(net)
    layer = config.diffusion.score_network.params.conditioning.context_transformer_layer.params
    got = export_unet_params(net, heads=layer.heads, dim_head=layer.dim_head)
    tree = traverse_util.unflatten_dict(
        {("params",) + tuple(k.split("/")): v for k, v in state_dict_to_flax(net).items()})
    want = jax_export(tree, heads=layer.heads, dim_head=layer.dim_head)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == np.float32 and np.array_equal(got[k], np.asarray(want[k])), k
    jconfig = jax_load_yaml(path)
    jax_import(jconfig, _jax_zeros(JaxDDPM(jconfig), {}), got, strict=True)
    _scramble(net)
    import_score_network_params(config, net, {k: torch.from_numpy(v) for k, v in got.items()})
    _assert_equal_states(net.state_dict(), seeded)
    with pytest.raises(KeyError, match="unmapped flax path in export"):
        export_unet_params(torch.nn.ModuleDict({"stray": torch.nn.Linear(2, 2)}))


# ---- the import CLI -----------------------------------------------------------------


def _import_cli(capsys, *args):
    from xdiffusion_tpu_torch import import_torch_checkpoint

    import_torch_checkpoint.main(list(args) + ["--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("form", ["pt", "ddp", "safetensors"])
def test_import_cli_writes_a_checkpoint_the_port_reads(form, tmp_path, monkeypatch, capsys):
    """The reference trainer's {"model_state_dict": ...} `.pt`, a DDP dump
    whose keys carry "module.", and a `.safetensors` file written by the
    `safetensors` package: the CLI's JSON line (the JAX tool's keys; its
    `flax_param_leaves` counts the port's parameters); a checkpoint whose
    parameters and EMA equal the seeded network's bit for bit, which
    restore_checkpoint (with and without an EMA in the state), the trainer's
    resume and the sampling CLI read; --non_strict takes a partial file."""
    from xdiffusion_tpu_torch import checkpoints, sample as sample_cli
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.importers.export_torch import export_unet_params
    from xdiffusion_tpu_torch.optim import default_optimizer
    from xdiffusion_tpu_torch.train_step import create_train_state

    path = _flagship(tmp_path)
    config = load_yaml(path)
    net = GaussianDiffusion_DDPM(config, device="cpu").score_network()
    seeded = _seeded(net)
    layer = config.diffusion.score_network.params.conditioning.context_transformer_layer.params
    sd = {k: torch.from_numpy(v) for k, v in
          export_unet_params(net, heads=layer.heads, dim_head=layer.dim_head).items()}
    if form == "safetensors":
        save_file = pytest.importorskip("safetensors.torch").save_file
        file = str(tmp_path / "reference.safetensors")
        save_file(sd, file)
    else:
        file = str(tmp_path / "reference.pt")
        if form == "ddp":
            torch.save({"module." + k: v for k, v in sd.items()}, file)
        else:
            torch.save({"model_state_dict": sd, "step": 1234}, file)
    out = str(tmp_path / "imported")
    info = _import_cli(capsys, "--config_path", path, "--torch_checkpoint", file,
                       "--output", out, "--step", "1234")
    assert info == {"imported_torch_tensors": len(sd),
                    "flax_param_leaves": len(list(net.parameters())),
                    "output": os.path.abspath(out), "step": 1234}
    payload = torch.load(os.path.join(out, "1234.pt"), weights_only=True)
    _assert_equal_states(payload["params"], seeded)
    _assert_equal_states(payload["ema"], seeded)

    for ema in (True, False):
        model = GaussianDiffusion_DDPM(config, device="cpu")
        state = create_train_state(model, default_optimizer().build(
            model.score_network().parameters()), ema=ema)
        _, step = checkpoints.restore_checkpoint(out, state)
        assert step == 1234
        _assert_equal_states(model.score_network().state_dict(), seeded)
    samples = sample_cli.main(["--config_path", path, "--checkpoint", out, "--num_samples", "2",
                               "--sampling_steps", "2", "--output_path", str(tmp_path / "s"),
                               "--sampler_config_path",
                               os.path.join(CONFIGS, "image/mnist/samplers/ddim.yaml"),
                               "--device", "cpu"])
    assert samples.shape == (2, 16, 16, 1) and os.path.exists(tmp_path / "s/sample-step1234.png")

    if form == "pt":
        partial = {k: v for k, v in sd.items() if not k.startswith("final_projection")}
        torch.save(partial, file)
        with pytest.raises(KeyError, match="final_projection"):
            _import_cli(capsys, "--config_path", path, "--torch_checkpoint", file,
                        "--output", out)
        info = _import_cli(capsys, "--config_path", path, "--torch_checkpoint", file,
                           "--output", str(tmp_path / "partial"), "--non_strict")
        assert info["imported_torch_tensors"] == len(partial)


def test_import_cli_resume_through_the_trainer(tmp_path, capsys):
    """The trainer's --resume_from takes the imported checkpoint (which holds
    an EMA the config does not track) and trains on from its step."""
    from xdiffusion_tpu_torch.config import load_yaml
    from xdiffusion_tpu_torch.diffusion.ddpm import GaussianDiffusion_DDPM
    from xdiffusion_tpu_torch.importers.export_torch import export_unet_params
    from xdiffusion_tpu_torch.training.image.train import train
    from test_torch_port_train import tiny_config

    path = tiny_config(tmp_path / "fast.yaml", fast_sampling=True)
    net = GaussianDiffusion_DDPM(load_yaml(path), device="cpu").score_network()
    _seeded(net)
    file = str(tmp_path / "reference.pt")
    torch.save({k: torch.from_numpy(v) for k, v in export_unet_params(net, dim_head=32).items()},
               file)
    out = str(tmp_path / "imported")
    _import_cli(capsys, "--config_path", path, "--torch_checkpoint", file, "--output", out,
                "--step", "3")
    run = train(path, num_training_steps=4, batch_size=2, output_path=str(tmp_path / "run"),
                resume_from=out, device="cpu", num_samples=2)
    with open(os.path.join(run, "metrics.jsonl")) as f:
        steps = [json.loads(line)["step"] for line in f]
    assert steps == [3] and os.path.exists(os.path.join(run, "checkpoints", "4.pt"))


def test_vae_component_writes_the_vae_checkpoint(tmp_path, capsys, monkeypatch):
    """--component vae on tests/fixtures/vae_import_cli.yaml: the JAX tool's
    JSON line and a checkpoint whose parameters (`ae.*`) are the seeded
    autoencoder's, which load_vae_params reads."""
    import copy

    from xdiffusion_tpu_torch.config import instantiate_from_config
    from xdiffusion_tpu_torch.importers.autoencoders import import_autoencoder_kl_params
    from xdiffusion_tpu_torch.training.image.autoencoder import load_vae_params

    vae = instantiate_from_config(copy.deepcopy(_kl()), use_config_struct=True, device="cpu")
    seeded = _seeded(vae.ae)
    sd = reference_layout(vae.ae, import_autoencoder_kl_params, monkeypatch)
    file = str(tmp_path / "vae.pt")
    torch.save({"model_state_dict": {k: torch.from_numpy(v) for k, v in sd.items()}}, file)
    out = str(tmp_path / "vae")
    info = _import_cli(capsys, "--config_path", os.path.join(FIXTURES, "vae_import_cli.yaml"),
                       "--torch_checkpoint", file, "--output", out, "--component", "vae")
    assert info == {"component": "vae", "importer": "import_autoencoder_kl_params",
                    "imported_torch_tensors": len(sd), "output": os.path.abspath(out),
                    "step": 0}
    params = load_vae_params(out, "cpu")
    _assert_equal_states({k[3:]: v for k, v in params.items() if k.startswith("ae.")}, seeded)


def test_safetensors_reader_and_writer_against_the_package(tmp_path):
    """The port's reader on the package's file and the package's reader on
    the port's: F32, F16 and BF16 tensors (and a 0-d one) bit for bit."""
    st = pytest.importorskip("safetensors.torch")
    from xdiffusion_tpu_torch.importers.safetensors_io import load_safetensors, save_safetensors

    g = torch.Generator().manual_seed(0)
    tensors = {"a.weight": torch.randn(3, 5, generator=g),
               "b": torch.randn(7, generator=g).half(),
               "c.bias": torch.randn(2, 3, 4, generator=g).bfloat16(),
               "scalar": torch.tensor(0.25)}
    st.save_file(tensors, str(tmp_path / "pkg.safetensors"))
    ours = load_safetensors(str(tmp_path / "pkg.safetensors"))
    save_safetensors(str(tmp_path / "port.safetensors"), tensors)
    theirs = st.load_file(str(tmp_path / "port.safetensors"))
    for got in (ours, theirs):
        assert sorted(got) == sorted(tensors)
        for k, v in tensors.items():
            assert got[k].dtype == v.dtype and got[k].shape == v.shape
            assert torch.equal(got[k], v), k
