"""The harness on the CPU at the configurations' tiny presets: the
reference against the port's modules, a dry run of each cell with a
well-formed last line, the import and file boundary, the control and the
faults the check has to refuse, and a cell added by new files alone.
`test_control_on_card` is marked `gpu` and decides inside the test
whether a card is there."""
import ast
import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from portbench.harness import core
from portbench.harness.weights import seed_params_
from portbench.reference import diffusion as RD

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PB)
RUN = os.path.join(PB, "run.py")
KEYS = ["correct", "attempted", "failed", "metrics", "device", "check"]
CELLS = [w["name"] for w in json.load(open(os.path.join(
    ROOT, "BENCHMARK.json")))["workloads"]]
# the first cell of the mvedit configuration and its traffic mix
MVEDIT = next(c for c in CELLS if c.startswith("mvedit_sd15."))
MVEDIT_MIX = MVEDIT.split(".", 1)[1]
TRAIN = next(c for c in CELLS if c.endswith(".train"))


def _env(tmp_path):
    env = dict(os.environ)
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        d = tmp_path / k.lower()
        d.mkdir(exist_ok=True)
        env[k] = str(d)
    env.pop("JAX_PLATFORMS", None)
    return env


def _run(args, tmp_path, run=RUN):
    res = subprocess.run([sys.executable, run, "--device", "cpu",
                          "--preset", "tiny", *args], capture_output=True,
                         text=True, env=_env(tmp_path), timeout=900)
    return res


def _last(res):
    assert res.returncode == 0, res.stderr[-4000:]
    line = res.stdout.strip().splitlines()[-1]
    return json.loads(line)


# --------------------------------------------------------------------------
def _tiny_cfgs():
    cfg = json.load(open(os.path.join(PB, "configs", "mvedit_sd15.json")))
    t = cfg["tiny"]
    u = dict(t["unet"], block_out_channels=tuple(
        t["unet"]["block_out_channels"]), attn_down=tuple(
        t["unet"]["attn_down"]))
    v = dict(t["vae"], block_out_channels=tuple(
        t["vae"]["block_out_channels"]))
    return u, v, t["controlnet_hint_strides"]


def _same_params(port, ref):
    a = {k: tuple(p.shape) for k, p in port.named_parameters()}
    b = {k: tuple(p.shape) for k, p in ref.named_parameters()}
    assert a == b


def _rel(a, b):
    return float((a.double() - b.double()).norm() / b.double().norm())


def test_reference_matches_the_port_at_tiny_size():
    from mvedit_tpu_torch.models.diffusion import (AutoencoderKL,
                                                   ControlNet,
                                                   UNet2DCondition,
                                                   UNetConfig, VAEConfig)
    from mvedit_tpu_torch.models.diffusion.attention import AttnMode
    u, v, hs = _tiny_cfgs()
    dev = torch.device("cpu")
    pu = UNet2DCondition(UNetConfig(**u, dtype=torch.float32))
    ru = RD.UNet(RD.UNetCfg(**u))
    pc = ControlNet(UNetConfig(**u, dtype=torch.float32), hint_strides=hs)
    rc = RD.ControlNet(RD.UNetCfg(**u), hs)
    pv = AutoencoderKL(VAEConfig(**v, dtype=torch.float32))
    rv = RD.VAE(RD.VAECfg(**v))
    for (p, r), tag in (((pu, ru), "UNet2DCondition:0"),
                        ((pc, rc), "ControlNet:1"),
                        ((pv, rv), "AutoencoderKL:0")):
        _same_params(p, r)
        seed_params_(p, 11, tag, dev)
        seed_params_(r, 11, tag, dev)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(4, 8, 8, 4, generator=g)
    t = torch.tensor([10, 10, 500, 500])
    ehs = torch.randn(4, 7, u["cross_attention_dim"], generator=g)
    hint = torch.rand(4, 16, 16, 3, generator=g)
    with torch.no_grad():
        mode = AttnMode(num_views=2)
        dmode = {"num_views": 2, "ip_tokens": 0, "ip_scale": 1.0}
        pd, pm = pc(x, t, ehs, hint, 0.8, mode)
        rdn, rm = rc(x, t, ehs, hint, 0.8, dmode)
        assert max(_rel(a, b) for a, b in zip(pd + [pm], rdn + [rm])) < 1e-5
        pe = pu(x, t, ehs, part="enc", mode=mode)
        re = ru(x, t, ehs, part="enc", mode=dmode)
        assert _rel(pe["h"], re["h"]) < 1e-5
        out = pu(None, None, None, part="dec", enc_state=pe, mode=mode,
                 down_block_res=pd, mid_block_res=pm)
        ref = ru(None, None, None, part="dec", enc_state=re, mode=dmode,
                 down_block_res=rdn, mid_block_res=rm)
        assert _rel(out, ref) < 1e-5
        img = torch.rand(2, 32, 32, 3, generator=g) * 2 - 1
        assert _rel(pv.encode(img), rv.encode(img)) < 1e-5
        assert _rel(pv.decode(x[:2]), rv.decode(x[:2])) < 1e-5


# --------------------------------------------------------------------------
@pytest.mark.parametrize("cell", CELLS)
def test_dry_run_prints_a_well_formed_last_line(cell, tmp_path):
    before = {d: set(os.listdir(d)) for d in ("/tmp", "/dev/shm")
              if os.path.isdir(d)}
    res = _run(["--workload", cell, "--seed", str(2 ** 31 + 5),
                "--seconds", "1"], tmp_path)
    out = _last(res)
    assert list(out) == KEYS
    assert out["correct"] is True, res.stderr[-3000:]
    assert out["failed"] == 0 and out["attempted"] >= 1
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    want = {m["name"] for m in man["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]}
    assert set(out["metrics"]) <= want and "setup_s" in out["metrics"]
    # the compared numbers close standard error, each beside its limit
    tail = res.stderr.strip().splitlines()[-len(out["check"]):]
    assert all(line.startswith("check ") and " limit " in line
               for line in tail)
    # nothing written to fixed paths outside the run's own directories
    for d, names in before.items():
        assert set(os.listdir(d)) - names == set(), d


@pytest.mark.parametrize("cell", CELLS)
def test_traced_dry_run_reports_per_layer_metrics(cell, tmp_path):
    res = _run(["--workload", cell, "--seed", "17", "--seconds", "1",
                "--trace", "1"], tmp_path)
    out = _last(res)
    assert list(out) == KEYS[:5] + ["breakdown", "check"]
    assert out["correct"] is True
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    allowed = {m["name"] for m in man["per_layer"]}
    assert out["metrics"] and set(out["metrics"]) <= allowed
    assert "busy_s" in out["device"] and "window_s" in out["device"]
    for k in ("device_ops", "idle_gaps"):
        assert len(out["breakdown"][k]) <= 10


def test_no_jax_in_the_run_and_none_in_the_reference(tmp_path):
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import portbench.run as R; "
            "R.main(['--workload', %r, '--seed', '3', '--seconds', '1', "
            "'--device', 'cpu', '--preset', 'tiny']); "
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % MVEDIT)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_env(tmp_path), timeout=900)
    assert res.returncode == 0, res.stderr[-3000:]
    tops = set(eval(res.stdout.strip().splitlines()[-1]))
    assert not tops & set(core.FORBIDDEN)
    assert "mvedit_tpu_torch" in tops
    # the reference imports nothing of the port, and no file of the
    # benchmark reads the JAX package's benchmarks or smoke
    for dirpath, _, files in os.walk(PB):
        for f in files:
            if not f.endswith(".py"):
                continue
            path = os.path.join(dirpath, f)
            tree = ast.parse(open(path).read())
            names = [a.name for n in ast.walk(tree)
                     if isinstance(n, ast.Import) for a in n.names]
            names += [n.module or "" for n in ast.walk(tree)
                      if isinstance(n, ast.ImportFrom) and n.level == 0]
            tops = {n.split(".")[0] for n in names}
            assert not tops & (set(core.FORBIDDEN) | {
                "bench", "benchmarks", "chip_smoke"}), path
            if "reference" in dirpath.split(os.sep):
                assert "mvedit_tpu_torch" not in tops, path


def test_the_run_refuses_a_process_that_holds_jax(monkeypatch):
    monkeypatch.setitem(sys.modules, "jaxlib", object())
    with pytest.raises(SystemExit) as e:
        core.refuse_jax()
    assert e.value.code != 0


# --------------------------------------------------------------------------
def test_control_is_refused(tmp_path):
    out = _last(_run(["--workload", MVEDIT, "--seed", "23", "--seconds",
                      "1", "--control", "1"], tmp_path))
    assert out["correct"] is False


def _fault_run(monkeypatch, fault):
    from mvedit_tpu_torch.models.diffusion.unet import UNet2DCondition
    if fault == "unchanged":
        # the denoiser's step leaves the latents as they are: epsilon 0
        orig = UNet2DCondition.forward

        def broken(self, *a, **k):
            out = orig(self, *a, **k)
            if isinstance(out, dict):
                return dict(out, h=torch.zeros_like(out["h"]))
            return torch.zeros_like(out)
        monkeypatch.setattr(UNet2DCondition, "forward", broken)
    elif fault == "half_batch":
        # the fits' gradient sums take half of their contributions, scaled
        # to the mean over the rest
        import mvedit_tpu_torch.ops.segment as OS
        orig = OS.segment_sum

        def broken(idx, vals, size, **kw):
            idx = idx.clone()
            idx[1::2] = size
            return orig(idx, vals * 2, size, **kw)
        monkeypatch.setattr(OS, "segment_sum", broken)
    elif fault == "fit_step_skipped":
        # the fits' optimiser step returns with the parameters unchanged
        monkeypatch.setattr(torch.optim.Adam, "step",
                            lambda self, closure=None: None)
    elif fault == "gather_altered":
        # a row gather's answer altered where it is produced
        orig_sel = torch.Tensor.index_select

        def altered_sel(self, dim, index):
            out = orig_sel(self, dim, index)
            if self.is_floating_point() and self.dim() == 2 and out.numel():
                out = out.clone()
                out.view(-1)[0] += 1
            return out
        monkeypatch.setattr(torch.Tensor, "index_select", altered_sel)
    elif fault == "bake_altered":
        # the bake's albedo altered where the field produces it
        from mvedit_tpu_torch.models.fields import FieldColor
        orig_call = FieldColor.__call__
        monkeypatch.setattr(FieldColor, "__call__",
                            lambda self, p, x: orig_call(self, p, x) + 0.01)
    else:
        import importlib
        rz = importlib.import_module("mvedit_tpu_torch.models.mesh.rasterize")
        orig_sel = rz.raster_select

        def altered(*a, **k):
            best, key, face = orig_sel(*a, **k)
            face = face.clone()
            face.view(-1)[0] += 1
            return best, key, face
        monkeypatch.setattr(rz, "raster_select", altered)
    import portbench.run as R
    monkeypatch.setattr(core, "refuse_jax", lambda: None)
    return R.main(["--workload", MVEDIT, "--seed", "29", "--seconds", "1",
                   "--device", "cpu", "--preset", "tiny"])


def _train_fault_run(monkeypatch, fault):
    import mvedit_tpu_torch.models.ssdnerf as SN
    orig = SN.make_train_step
    if fault == "loader_altered":
        # the loader's decoded colours altered where they are produced
        from mvedit_tpu_torch.datasets.shapenet_srn import ShapeNetSRN
        get = ShapeNetSRN.__getitem__

        def altered(self, idx):
            out = get(self, idx)
            return dict(out, images=out["images"][..., ::-1].copy())
        monkeypatch.setattr(ShapeNetSRN, "__getitem__", altered)

    def broken_make(*a, **k):
        step_fn = orig(*a, **k)

        def step(state, batch, generator=None, draws=None):
            if fault == "unchanged":
                # the step hands its state back as it came
                return state, step_fn(state, batch, generator, draws)[1]
            if fault == "half_batch":
                # the loss of the first half of the scenes, the rest left
                h = state["codes"].shape[0] // 2
                part = {k: state[k][:h] for k in ("codes", "code_m",
                                                  "code_v", "code_steps")}
                new, m = step_fn(dict(state, **part),
                                 {k: v[:h] for k, v in batch.items()},
                                 generator, None if draws is None else
                                 {k: v[:h] for k, v in draws.items()})
                for k in part:
                    new[k] = torch.cat([new[k], state[k][h:]])
                return new, m
            new, m = step_fn(state, batch, generator, draws)
            # the loss altered where the step produces it
            return new, dict(m, loss_diffusion=m["loss_diffusion"] * 1.05)
        return step
    monkeypatch.setattr(SN, "make_train_step", broken_make)
    import portbench.run as R
    monkeypatch.setattr(core, "refuse_jax", lambda: None)
    return R.main(["--workload", TRAIN, "--seed",
                   "31", "--seconds", "1", "--device", "cpu", "--preset",
                   "tiny"])


# the number each fault has to fail, beside `correct`
FAULTS = {"unchanged": "unet_rel", "half_batch": "segment_err",
          "altered": "raster_mismatch", "fit_step_skipped": "fit_step_rel",
          "gather_altered": "gather_mismatch", "bake_altered": "bake_rel"}


@pytest.mark.parametrize("fault", list(FAULTS))
def test_a_broken_timed_path_is_refused(fault, monkeypatch, capsys):
    res = _fault_run(monkeypatch, fault)
    assert res["correct"] is False, res["check"]
    c = res["check"][FAULTS[fault]]
    assert c["value"] is None or c["value"] > c["limit"], res["check"]


TRAIN_FAULTS = {"unchanged": "change3_rel", "half_batch": "grad1_rel",
                "altered": "loss_rel", "loader_altered": "loader_mismatch"}


@pytest.mark.parametrize("fault", list(TRAIN_FAULTS))
def test_a_broken_training_step_is_refused(fault, monkeypatch, capsys):
    res = _train_fault_run(monkeypatch, fault)
    assert res["correct"] is False, res["check"]
    c = res["check"][TRAIN_FAULTS[fault]]
    assert c["value"] is None or c["value"] > c["limit"], res["check"]


# --------------------------------------------------------------------------
TOY_PY = '''
import torch


def build(cfg, seed, device, preset):
    return Toy(cfg, seed, device)


class Toy:
    def __init__(self, cfg, seed, device):
        g = torch.Generator().manual_seed(seed)
        self.w = torch.randn(cfg["width"], cfg["width"], generator=g)
        self.out = None

    def install(self, sites, traffic):
        self.sites = sites

    def phase_timer(self, on):
        return None

    def request(self, traffic, ctx, warmup=False):
        self.out = self.w @ self.w
        return {"ok": True}

    def free(self):
        pass

    def compare(self, captures, control=False):
        return {"toy_err": float((self.out - self.w @ self.w).abs().max())}
'''

# a loop kind of its own: a fixed number of requests, no warm-up
ONE_SHOT_PY = '''
import time


class Loop:
    def __init__(self, system, traffic, seed, workdir, device):
        self.system, self.traffic = system, traffic

    def run(self, seconds, hooks, begin, end):
        begin()
        records = []
        for i in range(self.traffic["requests"]):
            t = time.perf_counter()
            with hooks.request(i):
                res = self.system.request(self.traffic, {"seed": i})
            records.append(dict(wall=time.perf_counter() - t, ok=res["ok"]))
        end()
        return dict(window_s=sum(r["wall"] for r in records),
                    records=records, attempted=len(records), failed=0)
'''


def _files(root):
    return {os.path.relpath(os.path.join(dp, f), root):
            open(os.path.join(dp, f), "rb").read()
            for dp, _, fs in os.walk(root) for f in fs
            if not f.endswith(".pyc")}


def test_a_cell_added_by_new_files_alone(tmp_path):
    """A configuration, a loop kind, two traffic mixes (one of them a new
    mix of `mvedit_sd15` on another endpoint's arguments) and a metric,
    each a new file found by its name; no file of the benchmark edited."""
    co = tmp_path / "checkout"
    shutil.copytree(PB, co / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    os.symlink(os.path.join(ROOT, "mvedit_tpu_torch"), co / "mvedit_tpu_torch")
    man = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    pb = co / "portbench"
    before = _files(pb)
    (pb / "configs" / "toy.json").write_text(json.dumps(
        {"name": "toy", "width": 16, "tiny": {"width": 8}}))
    (pb / "configs" / "toy.py").write_text(TOY_PY)
    (pb / "loops" / "one_shot.py").write_text(ONE_SHOT_PY)
    (pb / "traffic" / "toy_mix.json").write_text(json.dumps(
        {"loop": "one_shot", "requests": 3, "limits": {"toy_err": 0.0}}))
    # a mix of the mvedit configuration on another endpoint, data alone
    retex = json.load(open(pb / "traffic" / f"{MVEDIT_MIX}.json"))
    retex["call"] = {"method": "run_retex", "args": {
        "mesh_path": "@input", "prompt": "@prompt", "seed": "@seed",
        "out_path": "@out_path", "steps": "$retex_steps",
        "denoising_strength": "$retex_denoising_strength",
        "n_inverse_steps": "$retex_n_inverse_steps",
        "num_views": "$retex_num_views"}}
    retex["warmup"] = {"steps": 2, "n_inverse_steps": 2}
    retex["tiny"] = dict(retex["tiny"], warmup=retex["warmup"], fit_steps=12)
    retex["prompts"] = ["a knot of green glass"]
    retex["limits"] = {k: v for k, v in retex["limits"].items()
                       if "@" not in k}
    (pb / "traffic" / "retex_plain.json").write_text(json.dumps(retex))
    (pb / "metrics" / "toy_requests.req.py").write_text(
        "def read(ctx):\n    return float(len(ctx['records']))\n")
    man["configs"].append({"name": "toy", "source": "https://example.org",
                           "file": "portbench/configs/toy.json",
                           "reduced": [], "why": "a test"})
    man["workloads"] += [
        {"name": "toy.mix", "config": "toy", "traffic": "toy_mix",
         "chips": 1, "why": "a test"},
        {"name": "mvedit_sd15.retex_plain", "config": "mvedit_sd15",
         "traffic": "retex_plain", "chips": 1, "why": "a test"}]
    man["per_layer"].append({"name": "toy_requests.req", "unit": "1",
                             "better": "higher", "source": "host_clock",
                             "layer": "toy", "moves": "request_s",
                             "workloads": ["toy.mix"]})
    for m in man["end_to_end"]:
        if f"mvedit_sd15.{MVEDIT_MIX}" in m.get("workloads", []):
            m["workloads"].append("mvedit_sd15.retex_plain")
    (co / "BENCHMARK.json").write_text(json.dumps(man))

    def run(cell, trace):
        return _last(subprocess.run(
            [sys.executable, str(pb / "run.py"), "--workload", cell,
             "--seed", "1", "--seconds", "0.01", "--trace", trace,
             "--device", "cpu", "--preset", "tiny"], capture_output=True,
            text=True, env=_env(tmp_path), cwd=co, timeout=600))
    out = run("toy.mix", "1")
    assert out["correct"] is True
    assert out["metrics"]["toy_requests.req"]["value"] == 3
    assert out["attempted"] == 3
    out = run("mvedit_sd15.retex_plain", "0")
    assert out["correct"] is True and out["attempted"] >= 2, out["check"]
    assert "request_s" in out["metrics"]
    after = _files(pb)
    assert all(after[p] == b for p, b in before.items())


# --------------------------------------------------------------------------
@pytest.mark.gpu
def test_control_on_card(tmp_path):
    """The control at the cell's own size on the card: the check refuses
    it on three seeds."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    for seed in (101, 202, 303):
        res = subprocess.run([sys.executable, RUN, "--workload", MVEDIT,
                              "--seed", str(seed), "--seconds", "1",
                              "--control", "1"], capture_output=True,
                             text=True, timeout=900)
        assert _last(res)["correct"] is False
