"""One rank of the port's multi-rank CPU tests (imports no JAX).

    python tests/torch_dist_worker.py SUITE RANK WORLD DIR

Joins a gloo group through a `file://` store under DIR, runs SUITE's cases
on the inputs the test saved (`DIR/SUITE-inputs.pt`) and saves what they
return to `DIR/SUITE-rank{RANK}.pt`.  `spawn` (used by the tests) starts
the WORLD ranks of one suite and returns their results.
"""

import os
import subprocess
import sys

import torch
import torch.distributed as dist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


class Ranks:
    """The WORLD rank processes of one suite, started in the background;
    `results()` waits for them (once) and returns each rank's results."""

    def __init__(self, suite: str, world: int, directory: str, inputs: dict,
                 timeout: float = 300.0):
        self.suite, self.directory, self.timeout = suite, directory, timeout
        torch.save(inputs, os.path.join(directory, f"{suite}-inputs.pt"))
        env = {k: v for k, v in os.environ.items()
               if k not in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")}
        env["OMP_NUM_THREADS"] = "1"
        self.procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), suite, str(r), str(world), directory],
            cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for r in range(world)]
        self._results = None

    def close(self) -> None:
        """Stop ranks whose results nobody waited for."""
        for p in self.procs:
            if p.poll() is None:
                p.kill()
                p.communicate()

    def results(self):
        if self._results is None:
            outs = []
            for p in self.procs:
                try:
                    out, _ = p.communicate(timeout=self.timeout)
                except subprocess.TimeoutExpired:
                    for q in self.procs:
                        q.kill()
                    out, _ = p.communicate()
                outs.append(out)
            for r, (p, out) in enumerate(zip(self.procs, outs)):
                assert p.returncode == 0, f"{self.suite} rank {r} failed:\n{out[-4000:]}"
            self._results = [torch.load(os.path.join(self.directory,
                                                     f"{self.suite}-rank{r}.pt"),
                                        weights_only=False) for r in range(len(self.procs))]
        return self._results


def spawn(suite: str, world: int, directory: str, inputs: dict, timeout: float = 300.0):
    """Run SUITE on WORLD ranks; each rank's results, in rank order."""
    return Ranks(suite, world, directory, inputs, timeout).results()


def cli_argv(out_dir: str):
    """The tiny CLI's flags (two audio tracks, 2 steps) on the CPU."""
    audio = [os.path.join(ROOT, "assets", "audio_emb", f"000_{i}.pt") for i in (0, 1)]
    return ["--model_size", "tiny", "--device", "cpu", "--audio_path", *audio, "--num_frames",
            "9", "--height", "128", "--width", "192", "--num_inference_steps", "2",
            "--output_dir", out_dir]


def one_rank_cli(out_dir: str):
    from bindyouravatar_tpu_torch import infer

    return infer.run(infer.get_args(cli_argv(out_dir))).video


def two_stage_cli(argv, fail: bool = False):
    """`infer.main(argv + ["--two_stage_generate"])` (no SAM2 checkpoint:
    the mask tool's coarse masks) with the tool wrapped to count its calls
    on this rank, or (`fail`) replaced by one that raises; returns the
    calls, stage 2's clip (None if it did not run) and the error `main`
    raised (None if none)."""
    from bindyouravatar_tpu_torch import infer
    from bindyouravatar_tpu_torch.tools import sam2_tools

    os.environ.pop("BYA_SAM2_CKPT", None)
    calls, clips = [], []
    tool, second = sam2_tools.make_masks, infer.second_stage

    def counted(*a, **kw):
        calls.append(a)
        if fail:
            raise FileNotFoundError("stub mask tool: no such checkpoint")
        return tool(*a, **kw)

    def recorded(*a, **kw):
        out = second(*a, **kw)
        clips.append(out.video)
        return out

    sam2_tools.make_masks, infer.second_stage = counted, recorded
    error = None
    try:
        infer.main(argv + ["--two_stage_generate"])
    except RuntimeError as e:
        error = str(e)
    finally:
        sam2_tools.make_masks, infer.second_stage = tool, second
    return dict(calls=len(calls), clip=clips[0] if clips else None, error=error)


def two_stage_runs(inp, flags):
    """The two-stage CLI with `flags` (the mesh), and again with a failing
    tool."""
    return {"two_stage": two_stage_cli(inp["two_stage_argv"] + flags),
            "two_stage_fail": two_stage_cli(inp["two_stage_fail_argv"] + flags, fail=True)}


def two_stage_inputs(mktemp):
    """The two-stage CLI's flags for the ranks: one output directory for
    the run and one for the run whose tool fails."""
    return dict(two_stage_argv=cli_argv(str(mktemp("two_stage"))),
                two_stage_fail_argv=cli_argv(str(mktemp("two_stage_fail"))))


def check_two_stage(ranks, tmp_path):
    """`--two_stage_generate` under the mesh: the tool ran once (on rank
    0), and each rank's stage-2 clip equals one rank's within relative L2
    1e-5 (the CLI tests' bound)."""
    import numpy as np

    want = two_stage_cli(cli_argv(str(tmp_path)))
    assert want["error"] is None and want["calls"] == 1
    assert [r["two_stage"]["calls"] for r in ranks] == [1] + [0] * (len(ranks) - 1)
    for r in ranks:
        got = r["two_stage"]
        assert got["error"] is None and got["clip"].shape == want["clip"].shape
        diff = np.linalg.norm(got["clip"].astype(np.float64) - want["clip"])
        assert diff / np.linalg.norm(want["clip"].astype(np.float64)) < 1e-5


def check_two_stage_failure(ranks):
    """A tool that raises on rank 0: every rank raises, with the tool's
    error, and none runs stage 2 (none waits in a broadcast: the ranks
    returned within their timeout)."""
    for r in ranks:
        got = r["two_stage_fail"]
        assert got["clip"] is None
        assert "mask tool failed" in got["error"] and "stub mask tool" in got["error"], got


# ------------------------------------------------------------------ suites
def _dit(inp):
    from bindyouravatar_tpu_torch.models.dit import DiT

    dit = DiT.tiny(device="cpu", **inp["dit_kwargs"])
    dit.load_state_dict(inp["state"], strict=True)
    return dit.eval()


def suite_ring(inp, rank, world):
    """Ring attention over the world and the sp DiT step."""
    from bindyouravatar_tpu_torch.ops.ring_attention import ring_attention

    out = {}
    for name, case in inp["ring"].items():
        q, k, v = (t.chunk(world, dim=1)[rank].contiguous() for t in case["qkv"])
        out[name] = ring_attention(q, k, v, case["heads"], dist.group.WORLD,
                                   valid_len=case["valid_len"])
    dit = _dit(inp)
    with torch.no_grad():
        out["sp_out"], out["sp_routing"] = dit.apply(*inp["args"], sp_group=dist.group.WORLD,
                                                     **inp["kwargs"])
    out["cli"] = _cli(inp["cli_argv"] + ["--sp", str(world)])
    out.update(serve(inp["server"], rank, sp_group=dist.group.WORLD))
    out.update(two_stage_runs(inp, ["--sp", str(world)]))
    return out


def _cli(argv):
    """The CLI's clip (`infer.run`) on this rank."""
    from bindyouravatar_tpu_torch import infer

    return infer.run(infer.get_args(argv)).video


def suite_tp(inp, rank, world):
    """The TP DiT step and the TP server."""
    from bindyouravatar_tpu_torch.parallel.mesh import create_mesh
    from bindyouravatar_tpu_torch.parallel.tp import shard_params_tp

    mesh = create_mesh(dp=1, fsdp=1, tp=world, device_type="cpu")
    dit = shard_params_tp(_dit(inp), mesh)
    with torch.no_grad():
        out, _ = dit.apply(*inp["args"], **inp["kwargs"])
    res = {"tp_out": out, "heads": (dit.blocks[0].attn1.heads, dit.audio_layers[0].heads)}
    res.update(serve(inp["server"], rank, tp_mesh=mesh))
    res["cli"] = _cli(inp["cli_argv"] + ["--tp", str(world)])
    res.update(two_stage_runs(inp, ["--tp", str(world)]))
    return res


def serve_spec():
    """Two co-batchable requests on a drawn tiny pipeline (8 latent channels:
    noise + image), 2 steps."""
    import numpy as np

    from bindyouravatar_tpu_torch.config import PipelineConfig, tiny_dit_config

    c = tiny_dit_config()
    rng = np.random.default_rng(0)
    f = lambda *shape: rng.standard_normal(shape).astype(np.float32)
    reqs = [dict(prompt_embeds=f(1, c.max_text_seq_length, c.text_embed_dim),
                 image=rng.uniform(-1, 1, (1, 1, 3, c.sample_height * 8, c.sample_width * 8)
                                   ).astype(np.float32), seed=s, request_id=f"r{s}")
            for s in (1, 2)]
    return dict(dit_kwargs=dict(in_channels=8, out_channels=4, is_train_face=False,
                                is_train_audio=False),
                pipe_cfg=PipelineConfig(height=c.sample_height * 8, width=c.sample_width * 8,
                                        num_frames=c.sample_frames, num_inference_steps=2),
                requests=reqs)


def serve(spec, rank: int = 0, tp_mesh=None, sp_group=None):
    """The spec's requests through a server with `batch_max=2`, then a
    request that fails inside `generate` and the requests again: on
    one rank (no mesh, no group), or over the tp mesh or the sp group (rank
    0 submits, the others follow)."""
    import numpy as np

    from bindyouravatar_tpu_torch.models.dit import DiT
    from bindyouravatar_tpu_torch.models.vae import CausalVAE
    from bindyouravatar_tpu_torch.parallel.tp import shard_params_tp
    from bindyouravatar_tpu_torch.pipeline.pipeline import BindYourAvatarPipeline
    from bindyouravatar_tpu_torch.serving.server import GenerationRequest, InferenceServer

    gen = torch.Generator().manual_seed(0)
    dit = DiT.tiny(device="cpu", generator=gen, **spec["dit_kwargs"])
    vae = CausalVAE.tiny(device="cpu", generator=gen)
    pipe = BindYourAvatarPipeline.create(dit.eval(), vae.eval(), spec["pipe_cfg"])
    group = sp_group
    if tp_mesh is not None:
        shard_params_tp(pipe.dit, tp_mesh)
        group = tp_mesh["tp"].get_group()
    pipe.sp_group = sp_group
    server = InferenceServer(pipe, "cpu", batch_max=2, batch_wait_s=5.0, group=group)
    if rank != 0:
        server.follow()
        return {"served": server.requests_served}
    try:
        futs = [server.submit(GenerationRequest(**req)) for req in spec["requests"]]
        results = [f.result(timeout=300) for f in futs]
        # then a batch that raises inside `generate` on every rank (the
        # prompt one feature too wide; it cannot co-batch, so it runs
        # alone at once) and the pair again: the followers must stay in
        # step with rank 0
        bad = dict(spec["requests"][0], request_id="bad")
        bad["prompt_embeds"] = np.pad(bad["prompt_embeds"], ((0, 0), (0, 0), (0, 1)))
        futs = [server.submit(GenerationRequest(**req)) for req in [bad] + spec["requests"]]
        try:
            futs[0].result(timeout=300)
            failure = "no error"
        except Exception as e:   # noqa: BLE001 - the failure under test
            failure = repr(e)
        after = [f.result(timeout=300) for f in futs[1:]]
    finally:
        server.close()
    return {"videos": [r.video for r in results],
            "batch_sizes": [r.timings["batch_size"] for r in results],
            "failure": failure, "after_failure": [r.video for r in after]}


def _trainer(inp, mesh):
    from bindyouravatar_tpu_torch.config import SchedulerConfig, TrainConfig
    from bindyouravatar_tpu_torch.ops.scheduler import Schedule
    from bindyouravatar_tpu_torch.training.trainer import Trainer

    return Trainer(_dit(inp).train(), Schedule.create(SchedulerConfig()),
                   TrainConfig(**inp["train_cfg"]), mesh=mesh)


def local_draws(draws, index: int, count: int):
    """This rank's rows of each global micro-batch's draws (the layout of
    `mesh.local_batch`); the scalar coin and the dropout keep are shared."""
    rows = lambda t: t.reshape((count, -1) + tuple(t.shape[1:]))[index]
    return [{k: rows(v) if k in ("t", "noise", "keep_img", "keep_bg", "keep_mask") else v
             for k, v in d.items()} for d in draws]


def _copy(tree):
    """A copy of a state dict's tensors (whole tensors that are not split
    are the live ones, which the next step changes in place)."""
    if isinstance(tree, dict):
        return {k: _copy(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def two_steps(trainer, batch, draws):
    """Two `train_step`s on `batch`, step i with the global micro-batches'
    draws `draws[i]` (this rank's rows of them); the whole state after them
    (the trainable tensors, the EMA, each kind of optimizer state), each
    step's loss, the whole mean gradients each step handed the optimizer
    and the whole state after the first step (every rank calls it)."""
    from bindyouravatar_tpu_torch.parallel.sharding import gather_part

    state = trainer.init_state()
    index, count = (0, 1) if trainer.mesh is None else (trainer.batch_index, trainer.batch_count)
    losses, grads, first = [], [], None
    apply = trainer.apply_gradients

    def recording(state, g):
        grads.append({k: gather_part(t.clone(), trainer.trainable[k], trainer.parts.get(k))
                      for k, t in g.items()})
        return apply(state, g)

    trainer.apply_gradients = recording
    for step in draws:
        state, m = trainer.train_step(state, batch, draws=local_draws(step, index, count))
        losses.append(float(m["loss"]))
        if first is None:
            first = _copy(trainer.state_dict(state))
    sd = trainer.state_dict(state)
    return dict({k: v for k, v in sd.items() if k not in ("step", "count")}, loss=losses,
                grads=grads, first=first)


def optimizer_parts(case, world: int, rank: int, group):
    """`case["steps"]` updates of `case["cfg"]`'s optimizer on this rank's
    parts of whole tensors (`case["params"]`, split along `case["dims"]`
    as FSDP2 splits: torch.chunk's pieces, the last ones shorter or empty;
    None: replicated), each step's gradients `case["grads"][i]`; returns
    each rank's parts of the parameters and of every state tensor with the
    `Part` each lies in, for the test to put the whole tensors together."""
    from bindyouravatar_tpu_torch.config import TrainConfig
    from bindyouravatar_tpu_torch.parallel.sharding import Part
    from bindyouravatar_tpu_torch.training.trainer import make_optimizer

    parts, local = {}, {}
    for k, t in case["params"].items():
        d = case["dims"].get(k)
        if d is None:
            local[k] = t.clone()
            continue
        chunk = -(-t.shape[d] // world)
        start = min(rank * chunk, t.shape[d])
        parts[k] = Part(tuple(t.shape), d, start)
        local[k] = t.narrow(d, start, min(chunk, t.shape[d] - start)).clone()
    opt = make_optimizer(TrainConfig(**case["cfg"]))
    opt.shard(parts, group)
    groups = {"all": sorted(local)}
    state = opt.init(local, groups)
    cut = lambda k, g: g if k not in parts else g.narrow(parts[k].dim, parts[k].start,
                                                          local[k].shape[parts[k].dim])
    for i, grads in enumerate(case["grads"]):
        opt.step(local, {k: cut(k, g) for k, g in grads.items()}, state, groups,
                 {"all": case["cfg"]["learning_rate"]}, i)
    return dict(params=(local, {k: parts.get(k) for k in local}),
                **{kind: (ts, {k: opt.state_part(kind, k) for k in ts})
                   for kind, ts in state.items()})


def suite_train(inp, rank, world):
    """Two train steps over each (dp, fsdp) layout of `inp["layouts"]`,
    with AdamW and with each optimizer of `inp["optimizers"]`, the
    optimizers on parts of whole tensors (`inp["parts"]`), the mesh
    bring-up's all-reduce, and (with `inp["sft_argv"]`) the launcher."""
    from torch.distributed.tensor import DTensor

    from bindyouravatar_tpu_torch.parallel.mesh import (batch_rank, batch_sharding, create_mesh,
                                                         local_batch, replicated)

    out = {}
    for dp, fsdp in inp["layouts"]:
        mesh = create_mesh(dp=dp, fsdp=fsdp, device_type="cpu")
        tr = _trainer(inp, mesh)
        i, n = batch_rank(mesh)
        accum = inp["train_cfg"].get("grad_accum_steps", 1)
        batch = {k: v if v is None else local_batch(v, i, n, accum)
                 for k, v in inp["batch"].items()}
        out[f"dp{dp}_fsdp{fsdp}"] = two_steps(tr, batch, inp["draws"])
        for name, over in inp.get("optimizers", {}).items():
            tr = _trainer(dict(inp, train_cfg=dict(inp["train_cfg"], **over)), mesh)
            out[f"{name}-dp{dp}_fsdp{fsdp}"] = two_steps(tr, batch, inp["draws"])
        # the reduce over the flattened (dp, fsdp) axis: a [dp * fsdp] batch,
        # and the rows `local_batch` gives each rank laid out as
        # `batch_sharding` says
        x = torch.arange(4 * n, dtype=torch.float32).reshape(n, 4)
        part = local_batch(x, i, n)
        whole = DTensor.from_local(part, mesh, batch_sharding(mesh)).full_tensor()
        same = DTensor.from_local(x, mesh, replicated(mesh)).full_tensor()
        out[f"layout_dp{dp}_fsdp{fsdp}"] = bool(torch.equal(whole, x) and torch.equal(same, x))
        part = part.sum()
        dist.all_reduce(part)
        out[f"sum_dp{dp}_fsdp{fsdp}"] = float(part)
    for name, case in inp.get("parts", {}).items():
        out[f"parts-{name}"] = optimizer_parts(case, world, rank, dist.group.WORLD)
    if inp.get("sft_argv"):
        from bindyouravatar_tpu_torch.training import sft

        run = sft.main(inp["sft_argv"])
        out["sft_step"] = run.state.step
    return out


SUITES = {"ring": suite_ring, "tp": suite_tp, "train": suite_train}


def main():
    suite, rank, world, directory = sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4]
    torch.set_num_threads(1)
    from bindyouravatar_tpu_torch.parallel.mesh import init_distributed

    init_distributed(coordinator=f"file://{os.path.join(directory, suite + '-store')}",
                     num_processes=world, process_id=rank, backend="gloo")
    inp = torch.load(os.path.join(directory, f"{suite}-inputs.pt"), weights_only=False)
    out = SUITES[suite](inp, rank, world)
    torch.save(out, os.path.join(directory, f"{suite}-rank{rank}.pt"))
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
