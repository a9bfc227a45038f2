"""The kill and preempt drills of the JAX package's ``test_rewind.py``, run
on both packages from the same SimpleModel weights (the port at world 1,
global batch 8) under their elastic agents: a failed step restarts from
the RAM tier, and a preemption writes an emergency tag a new run resumes
from. Both give equal ``tier``, ``snapshot_step`` and ``steps_lost``,
losses within 1e-5 (fp32), and the same ``restart_log.jsonl`` record.
"""

import json
import os

import numpy as np

from deepspeed_tpu_torch.resilience import chaos as tchaos
from tests.test_torch_rewind import _clean_slate, batch, make_engine  # noqa: F401
from tests.test_torch_rewind import CFG, HIDDEN, LAYERS


def _jax_pair(rewind, extra=None):
    import jax

    import deepspeed_tpu
    from deepspeed_tpu.models import simple as jsimple

    params = jax.tree_util.tree_map(
        np.asarray, jsimple.SimpleModel(HIDDEN, LAYERS).init_params(jax.random.PRNGKey(0)))

    def jax_engine():
        cfg = {**CFG, "rewind": dict(rewind), **(extra or {})}
        engine, *_ = deepspeed_tpu.initialize(model=jsimple.SimpleModel(HIDDEN, LAYERS),
                                              model_parameters=params, config=cfg)
        return engine

    return params, jax_engine


def _drill(side, factory, save, num_steps, **agent_kw):
    if side == "jax":
        from deepspeed_tpu.elasticity import DSElasticAgent
    else:
        from deepspeed_tpu_torch.elasticity import DSElasticAgent
    seen = {}

    def batches():
        while True:
            yield batch()

    agent = DSElasticAgent(factory, save, **agent_kw)
    out = agent.run(batches, num_steps=num_steps,
                    step_callback=lambda step, loss: seen.__setitem__(step, float(loss)))
    return out, seen


def test_kill_drill_recovers_from_ram_as_jax(tmp_path):
    """A failed step (chaos fail on the 6th train_step) in both packages:
    the agent restarts from the RAM tier, snapshot 4, one step lost."""
    from deepspeed_tpu.resilience import chaos as jchaos

    from deepspeed_tpu import telemetry as jtel
    from deepspeed_tpu_torch import telemetry as ttel

    rewind = {"ram_interval": 2, "keep": 2}
    got, logs = {}, {}
    for side, chaos, tel in (("jax", jchaos, jtel), ("torch", tchaos, ttel)):
        extra = {"telemetry": {"enabled": True, "output_dir": str(tmp_path / f"{side}_tel"),
                               "trace": False}}
        params, jax_engine = _jax_pair(rewind, extra)
        factory = jax_engine if side == "jax" else \
            (lambda: make_engine(rewind, extra=extra, params=params))
        chaos.install_chaos(chaos.ChaosInjector(fail_at={"train_step": [6]}))
        try:
            out, seen = _drill(side, factory, str(tmp_path / side), 8,
                               checkpoint_interval=100, max_restarts=2,
                               install_signal_handlers=False)
        finally:
            chaos.uninstall_chaos()
            tel.deconfigure()
        rec = out["restart_log"][0]
        got[side] = ((out["status"], out["final_step"], out["restarts"]),
                     {k: rec[k] for k in ("tier", "snapshot_step", "steps_lost")}, seen)
        assert "ChaosError" in rec["error"] and rec["restore_s"] is not None
        with open(tmp_path / f"{side}_tel" / "restart_log.jsonl") as f:
            logs[side] = [json.loads(line) for line in f]
    assert got["torch"][:2] == got["jax"][:2] == (("complete", 8, 1), {
        "tier": "ram", "snapshot_step": 4, "steps_lost": 1})
    # restart_log.jsonl: one record, JAX's fields and values but the clocks,
    # the ids and the error's text
    (t,), (j,) = logs["torch"], logs["jax"]
    assert set(t) == set(j)
    assert {k: v for k, v in t.items() if k not in ("ts", "event_id", "backoff_s", "restore_s")} \
        == {k: v for k, v in j.items() if k not in ("ts", "event_id", "backoff_s", "restore_s")}
    j, t = got["jax"][2], got["torch"][2]
    assert j.keys() == t.keys()
    np.testing.assert_allclose([t[k] for k in sorted(t)], [j[k] for k in sorted(j)], atol=1e-5)


def test_preempt_drill_resumes_from_the_emergency_tag_as_jax(tmp_path):
    """Chaos ``preempt`` SIGTERMs the process at the 4th train_step; the
    agent stops at the boundary, writes ``emergency_step4`` beside the stale
    ``latest`` of the step-3 save, and a new run resumes from it, in both
    packages."""
    from deepspeed_tpu.resilience import chaos as jchaos
    from deepspeed_tpu.resilience import rewind as jrw
    from deepspeed_tpu.runtime.checkpoint_engine.engine import \
        wait_for_pending_saves as jwait
    from deepspeed_tpu_torch.resilience import rewind as trw
    from deepspeed_tpu_torch.runtime.checkpoint_engine.engine import \
        wait_for_pending_saves as twait

    rewind = {"ram_interval": 2, "keep": 2}
    params, jax_engine = _jax_pair(rewind)
    got = {}
    for side, chaos, rw, factory in (
            ("jax", jchaos, jrw, jax_engine),
            ("torch", tchaos, trw, lambda: make_engine(rewind, params=params))):
        save = str(tmp_path / side)
        chaos.install_chaos(chaos.ChaosInjector(preempt_at={"train_step": [4]}))
        try:
            out, seen = _drill(side, factory, save, 50, checkpoint_interval=3,
                               max_restarts=0, install_signal_handlers=True)
        finally:
            chaos.uninstall_chaos()
        jwait()
        twait()                         # each side's step-3 async save
        with open(os.path.join(save, "latest")) as f:
            latest = f.read().strip()
        rw.clear_ram_snapshots()
        out2, seen2 = _drill(side, factory, save, out["final_step"] + 2,
                             checkpoint_interval=100, install_signal_handlers=False)
        rec = out2["restart_log"][0]
        got[side] = ((out["status"], out["final_step"], latest, out2["status"],
                      out2["final_step"]),
                     {k: rec[k] for k in ("tier", "snapshot_step", "steps_lost")},
                     {**seen, **seen2})
    assert got["torch"][:2] == got["jax"][:2] == (
        ("preempted", 4, "global_step3", "complete", 6),
        {"tier": "emergency", "snapshot_step": 4, "steps_lost": 0})
    j, t = got["jax"][2], got["torch"][2]
    np.testing.assert_allclose([t[k] for k in sorted(t)], [j[k] for k in sorted(j)], atol=1e-5)
