"""Port parity, the front door: `flowcompare_tpu_torch.cli` and its config reader.

`load_config` against the JAX package's on every preset and on plain and
wandb YAML files written here by `yaml.safe_dump` (every preset's full
config, flow-style lists, the `wandb_version: 1` file that both packages
read as a plain one), the YAML subset reader against `yaml.safe_load` on
drawn configs and its refusals; then the CLI on `tests/test_model.py`'s
tiny config (the "idenity" embedder and the DGCNN one) with `--device cpu`:
train -> evaluate -> sample, `--batch-size`, pack -> train on the pack,
evaluate on the three checkpoint formats (a `convert`ed reference `.pt`
scoring as the `.pt` itself), and the round trip in a process where jax,
flax, yaml and msgpack cannot be imported. evaluate's printed nats equal
the port's `evaluate_on_test` on the same checkpoint and seed.
"""

import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

import jax

import flowcompare_tpu_torch as ft
from flowcompare_tpu.cli import load_config as jax_load_config
from flowcompare_tpu.configs import PRESETS as JAX_PRESETS
from flowcompare_tpu.model import FlowCompareModel as JaxModel
from flowcompare_tpu.train import save_checkpoint as jax_save_checkpoint
from flowcompare_tpu_torch.cli import load_config, main
from flowcompare_tpu_torch.configs import yaml_subset
from test_model import tiny_config
from test_torch_port_convert import reference_save_dict, torch_save_dict

torch.set_num_threads(2)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EMBEDDERS = {"idenity": {}, "dgcnn": {"input_embedder": "DGCNNembedder"}}


def _tiny(embedder: str = "idenity") -> dict:
    cfg = tiny_config(**EMBEDDERS[embedder])
    cfg.update(dict(n_epochs=5, batch_size=4, batches_per_save=100, make_samples=False))
    return cfg


def _write_tiny_yaml(path, embedder: str = "idenity") -> str:
    with open(path, "w") as f:
        yaml.safe_dump(_tiny(embedder), f)
    return str(path)


def _same(a, b) -> bool:
    """Equal, NaN equal to NaN."""
    return json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)


@pytest.mark.parametrize("name", sorted(JAX_PRESETS))
def test_load_config_presets_equal_jax(name):
    assert load_config(name) == jax_load_config(name)


def _config_files() -> dict:
    files = {}
    for name in sorted(JAX_PRESETS):
        cfg = jax_load_config(name)
        files[f"plain-{name}"] = yaml.safe_dump(cfg)
        files[f"wandb-{name}"] = yaml.safe_dump({k: {"desc": None, "value": v}
                                                 for k, v in cfg.items()})
        files[f"flow-{name}"] = yaml.safe_dump(cfg, default_flow_style=None, width=40)
    files["tiny"] = yaml.safe_dump(_tiny())
    files["partial-wandb"] = yaml.safe_dump({"latent_dim": {"desc": "x", "value": 32},
                                             "input_embedder": {"value": "idenity"}})
    # wandb's own config.yaml: its `wandb_version: 1` is no {..., value} map,
    # so both packages read the file as a plain one (ROADMAP queue C)
    files["wandb_version"] = ("wandb_version: 1\n\n_wandb:\n  desc: null\n  value:\n"
                              "    cli_version: 0.10.8\n    is_jupyter_run: false\n"
                              "batch_size:\n  desc: null\n  value: 20\n"
                              "hidden_dims:\n  desc: null\n  value:\n  - 512\n  - 512\n")
    files["comments"] = ("# a config\nlatent_dim: 16   # narrower\nlr: 3.0e-04\n"
                         "hidden_dims: [32, 32]  # flow style\nmin_lr: 1e-10\n"
                         "input_embedder: 'idenity'\nsave_model_path: \"save/x\"\n")
    return files


CONFIG_FILES = _config_files()


@pytest.mark.parametrize("case", sorted(CONFIG_FILES))
def test_load_config_files_equal_jax(tmp_path, case):
    path = tmp_path / "config.yaml"
    path.write_text(CONFIG_FILES[case])
    assert _same(load_config(str(path)), jax_load_config(str(path)))


REFUSED = {"anchor": "a: &x 1\nb: *x\n", "tag": "a: !!str 1\n", "block_scalar": "a: |\n  x\n",
           "folded_scalar": "a: >\n  x\n", "flow_mapping": "a: {b: 1}\n",
           "multi_document": "a: 1\n---\nb: 2\n", "directive": "%YAML 1.1\n---\na: 1\n",
           "complex_key": "? a\n: b\n", "timestamp": "a: 2021-01-01\n", "merge": "<<: 1\n",
           "nested_flow": "a: [1, [2]]\n", "unclosed": "a: 'x\n", "tab_indent": "a:\n\tb: 1\n",
           "mapping_in_value": "a: b: c\n"}


@pytest.mark.parametrize("case", sorted(REFUSED))
def test_yaml_subset_refuses(tmp_path, case):
    with pytest.raises(ValueError):
        yaml_subset.load(REFUSED[case])
    path = tmp_path / "config.yaml"
    path.write_text(REFUSED[case])
    with pytest.raises(ValueError):
        load_config(str(path))


_keys = st.from_regex(r"[a-z_][a-z0-9_]{0,12}", fullmatch=True)
_scalars = st.one_of(st.none(), st.booleans(), st.integers(-2 ** 70, 2 ** 70),
                     st.floats(), st.text(st.characters(blacklist_categories=("Cs",)),
                                          max_size=100))
_trees = st.recursive(_scalars, lambda inner: st.one_of(
    st.lists(inner, max_size=4), st.dictionaries(_keys, inner, max_size=4)), max_leaves=12)


@settings(max_examples=150, deadline=None, suppress_health_check=list(HealthCheck))
@given(st.dictionaries(_keys, _trees, max_size=6), st.sampled_from([20, 80, 1000]),
       st.booleans())
def test_yaml_subset_equals_safe_load_on_drawn_configs(doc, width, flow_lists):
    text = yaml.safe_dump(doc, width=width, allow_unicode=True,
                          default_flow_style=None if flow_lists else False)
    try:
        got = yaml_subset.load(text)
    except ValueError as e:
        # an empty dict is written `{}` and, in flow style, a dict of scalars
        # as a flow mapping and a list of lists nested: outside the subset
        assert "flow mapping" in str(e) or (flow_lists and "nested flow" in str(e)), text
        return
    assert yaml.safe_dump(got) == yaml.safe_dump(yaml.safe_load(text)), text


def test_yaml_subset_scalars_typed_as_safe_load():
    words = ["~", "null", "", "yes", "No", "on", "OFF", "true", "0", "-0", "0b101", "0x1F",
             "017", "1_000", "1:30", "-1:30:00", "1.5", "1.", ".5", "1.0e-10", "1e-10",
             "+.inf", "-.Inf", ".NaN", "190:20:30.15", "0o7", "x1", "1.2.3", "y", "=x"]
    for word in words:
        want = yaml.safe_load(f"a: {word}\n")["a"]
        got = yaml_subset.load(f"a: {word}\n")["a"]
        assert type(got) is type(want) and (got == want or (isinstance(want, float)
                                                            and math.isnan(want))), word


def _metrics(save_dir) -> list:
    return [json.loads(line) for line in open(os.path.join(save_dir, "metrics.jsonl"))]


@pytest.mark.parametrize("embedder", sorted(EMBEDDERS))
def test_cli_train_evaluate_sample_roundtrip(tmp_path, capsys, embedder):
    cfg_path = _write_tiny_yaml(tmp_path / "tiny.yaml", embedder)
    save_dir = str(tmp_path / "run")
    main(["train", "--config", cfg_path, "--save-dir", save_dir, "--run-name", "t",
          "--steps", "3", "--n-items", "8", "--device", "cpu", "--save-final", "--seed", "4"])
    lines = _metrics(save_dir)
    assert len(lines) == 3 and all(math.isfinite(r["loss"]) for r in lines)
    ckpt = os.path.join(save_dir, "t_final.pt")
    capsys.readouterr()
    main(["evaluate", "--checkpoint", ckpt, "--n-items", "8", "--device", "cpu", "--seed", "5"])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == {"nats", "mean_changed_fraction", "n_voxels"}
    assert printed["n_voxels"] == 8
    # the same checkpoint, dataset and seed through the library
    config, model, _ = ft.load_any_checkpoint(ckpt, "cpu")
    ds = ft.SyntheticVoxelDataset(n_items=8, batch_size=config["batch_size"],
                                  sample_size=config["sample_size"],
                                  n_samples_context=config["n_samples_context"],
                                  with_extra=config["using_extra_context"], mode="test",
                                  include_all=True)
    nats, changes = ft.evaluate_on_test(model, ds, generator=torch.Generator().manual_seed(5))
    assert printed["nats"] == nats
    assert printed["mean_changed_fraction"] == float(sum(changes) / len(changes))
    out = str(tmp_path / "cloud")
    main(["sample", "--checkpoint", ckpt, "--n-points", "128", "--out", out, "--n-items", "4",
          "--device", "cpu"])
    cloud = np.load(out + ".npz")
    assert cloud["points"].shape == (128, 3) and np.isfinite(cloud["points"]).all()
    assert capsys.readouterr().out.strip() == f"wrote {out}.npz"


def test_cli_train_batch_size_override(tmp_path):
    # 8 items / batch 4 -> 2 steps an epoch, so 2 steps stay inside epoch 0
    cfg_path = _write_tiny_yaml(tmp_path / "tiny.yaml")
    save_dir = str(tmp_path / "run_bs")
    main(["train", "--config", cfg_path, "--save-dir", save_dir, "--run-name", "t",
          "--steps", "2", "--n-items", "8", "--batch-size", "4", "--device", "cpu"])
    lines = _metrics(save_dir)
    assert len(lines) == 2 and lines[-1]["epoch"] == 0


def test_cli_pack_then_train_on_packed(tmp_path, capsys):
    cfg_path = _write_tiny_yaml(tmp_path / "tiny.yaml")
    pack = str(tmp_path / "train.fcpack")
    main(["pack", "--config", cfg_path, "--out", pack, "--data", "synthetic", "--n-items", "12"])
    assert json.loads(capsys.readouterr().out)["n_items"] == 12
    assert ft.PackedVoxelDataset(pack, batch_size=4).n_items == 12
    save_dir = str(tmp_path / "run_packed")
    main(["train", "--config", cfg_path, "--save-dir", save_dir, "--run-name", "tp",
          "--steps", "3", "--data", "packed", "--packed-file", pack, "--device", "cpu"])
    lines = _metrics(save_dir)
    assert len(lines) == 3 and all("loss" in r for r in lines)


def _evaluate(capsys, ckpt) -> dict:
    capsys.readouterr()
    main(["evaluate", "--checkpoint", ckpt, "--n-items", "8", "--device", "cpu"])
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_reads_the_three_checkpoint_formats(tmp_path, capsys):
    """A JAX package checkpoint, a reference .pt and the port's `convert`
    of that .pt: evaluate and sample take each; the converted file scores
    as the .pt itself; train resumes from the JAX one."""
    cfg = jax_load_config(_write_tiny_yaml(tmp_path / "tiny.yaml"))
    jm = JaxModel(cfg, remat=False)
    params, state = jm.init_params(jax.random.PRNGKey(0))
    jax_path = str(tmp_path / "m.msgpack")
    jax_save_checkpoint(jax_path, config=cfg, params=params, state=state)
    pt_path = str(tmp_path / "reference.pt")
    torch.save(torch_save_dict(reference_save_dict(cfg, params, state)), pt_path)
    converted = str(tmp_path / "converted.pt")
    main(["convert", "--torch-checkpoint", pt_path, "--out", converted])
    assert "converted" in capsys.readouterr().out
    results = {p: _evaluate(capsys, p) for p in (jax_path, pt_path, converted)}
    assert results[converted] == results[pt_path]
    assert all(r["n_voxels"] == 8 and math.isfinite(r["nats"]) for r in results.values())
    for i, path in enumerate((jax_path, pt_path, converted)):
        main(["sample", "--checkpoint", path, "--n-points", "32", "--out",
              str(tmp_path / f"s{i}"), "--n-items", "4", "--device", "cpu"])
        assert os.path.exists(tmp_path / f"s{i}.npz")
    main(["train", "--config", str(tmp_path / "tiny.yaml"), "--save-dir", str(tmp_path / "re"),
          "--steps", "1", "--n-items", "8", "--device", "cpu", "--resume", jax_path])
    assert len(_metrics(tmp_path / "re")) == 1


def test_cli_raises_without_cuda_unless_asked_for_the_cpu(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg_path = _write_tiny_yaml(tmp_path / "tiny.yaml")
    with pytest.raises(RuntimeError, match="--device cpu"):
        main(["train", "--config", cfg_path, "--save-dir", str(tmp_path / "r"), "--steps", "1"])
    main(["train", "--config", cfg_path, "--save-dir", str(tmp_path / "r"), "--steps", "1",
          "--n-items", "4", "--device", "cpu", "--save-final"])
    for cmd in (["evaluate"], ["sample"], ["view"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(cmd + ["--checkpoint", str(tmp_path / "r" / "run_final.pt")])


def test_cli_view_needs_dash(tmp_path):
    cfg_path = _write_tiny_yaml(tmp_path / "tiny.yaml")
    main(["train", "--config", cfg_path, "--save-dir", str(tmp_path / "r"), "--steps", "1",
          "--n-items", "4", "--device", "cpu", "--save-final"])
    with pytest.raises(ImportError, match="dash is not installed"):
        main(["view", "--checkpoint", str(tmp_path / "r" / "run_final.pt"), "--n-items", "2",
              "--device", "cpu"])


def test_cli_round_trip_without_jax_flax_yaml_msgpack(tmp_path):
    """`python -m flowcompare_tpu_torch.cli` in a process where jax, flax,
    yaml and msgpack cannot be imported: train, evaluate and sample on the
    CPU; the CLI's import loads no yaml."""
    cfg_path = _write_tiny_yaml(tmp_path / "tiny.yaml")
    code = f"""
import runpy, sys
for name in ("jax", "flax", "yaml", "msgpack"):
    sys.modules[name] = None
import flowcompare_tpu_torch.cli as cli
assert not any(m.split(".")[0] in ("jax", "flax", "yaml", "msgpack", "flowcompare_tpu")
               for m, mod in sys.modules.items() if mod is not None)
run = {str(tmp_path / "run")!r}
for argv in (["train", "--config", {cfg_path!r}, "--save-dir", run, "--steps", "2",
              "--n-items", "8", "--device", "cpu", "--save-final"],
             ["evaluate", "--checkpoint", run + "/run_final.pt", "--n-items", "8",
              "--device", "cpu"],
             ["sample", "--checkpoint", run + "/run_final.pt", "--n-points", "16", "--out",
              run + "/cloud", "--n-items", "4", "--device", "cpu"]):
    sys.argv = ["flowcompare-torch", *argv]
    try:
        runpy.run_module("flowcompare_tpu_torch.cli", run_name="__main__")
    except SystemExit as e:
        assert e.code in (None, 0), e.code
print("round trip done")
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.strip().endswith("round trip done")
    assert '"n_voxels": 8' in out.stdout
    assert os.path.exists(tmp_path / "run" / "cloud.npz")


def test_ams_batches_reshuffle_each_epoch():
    """`--data ams` trains from `_Batches`: a re-iterable whose every pass
    is one epoch of the JAX package's `batch_iterator` with that epoch's
    shuffle (the JAX CLI's `_Batches`)."""
    from flowcompare_tpu.data import batch_iterator as jax_batch_iterator
    from flowcompare_tpu_torch.cli import _Batches

    rng = np.random.default_rng(0)
    items = [(rng.normal(size=(5, 6)).astype(np.float32), rng.normal(size=(3, 6)).astype(
        np.float32), np.full((1,), i, np.float32)) for i in range(9)]
    batches = _Batches(items, 2, shuffle=True)
    assert len(batches) == 4
    epochs = [list(batches) for _ in range(3)]
    for epoch, got in enumerate(epochs):
        want = list(jax_batch_iterator(items, 2, shuffle=True, epoch=epoch))
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
    orders = [[int(v) for b in e for v in b[2][:, 0]] for e in epochs]
    assert orders[0] != orders[1] != orders[2]
    fixed = _Batches(items, 2, shuffle=False)
    assert [[int(v) for b in e for v in b[2][:, 0]] for e in (list(fixed), list(fixed))] == \
        [list(range(8))] * 2


@pytest.mark.parametrize("value", ["\x85", "a\x85b", " ", "a b", "a  \n b",
                                   "x\ry", "word " * 12])
@pytest.mark.parametrize("width", [20, 80])
def test_yaml_subset_reads_yaml_line_breaks(value, width):
    """NEL and CR read as line breaks, and the line and paragraph separators
    as breaks that stay, as `yaml.safe_load` reads them (drawn once by the
    test above: {'_': '\\x85'})."""
    text = yaml.safe_dump({"_": value}, width=width, allow_unicode=True,
                          default_flow_style=False)
    assert yaml_subset.load(text) == yaml.safe_load(text), text
