"""The Anakin rollout: env step, policy forward and LSTM carry, on the device.

Counterpart of ``distar_tpu.envs.jaxenv.anakin``. Podracer's Anakin layout
(PAPERS.md) keeps the whole agent-environment interaction on the
accelerator: ``AnakinRunner.rollout`` re-seeds finished lanes at the
window boundary, then runs ``unroll_len`` steps of observe ->
``Model.sample_action`` -> env step for B lanes at once, and observes the
bootstrap step, with no host copy and no host read inside the window
(``device_pure_report`` witnesses it; on CUDA it also runs the window
under ``torch.cuda.set_sync_debug_mode``). The window runs under
``torch.no_grad()`` (not ``inference_mode()``: its tensors reach the
learner's backward). The emitted batch is already in the time-major
collate layout ``learner.data.fake_rl_batch`` documents, so ``RLLearner``
trains on it unchanged through ``AnakinDataLoader``.

Semantics of the host actor's windows (actor/agent.py), as in the JAX
package:

* a lane whose episode finishes mid-window keeps stepping a frozen env
  (``core.step`` freezes the state and zeroes rewards after done) while
  every mask and behaviour_logp is zeroed: the learner sees dead padding;
* finished lanes get fresh scenarios at the next window boundary, their
  LSTM carry zeroed;
* ``teacher_logit`` is the behaviour policy's own logits (self-teacher):
  the loss's KL term is exactly zero without a second forward. A real
  teacher slots in through ``teacher_apply``.

**Away seat** (``opponent_seat=True``): a second, frozen model drives the
away team on its own observation, both action sets go to ``core.step``,
and the batch carries per-step episode outcomes (``match_result``), which
``AnakinDataLoader`` strips into a results buffer for league match
reports. The single-policy path is unchanged by it.

Randomness comes from the runner's ``torch.Generator`` on the device: the
fresh scenarios of a window, then every step's Gumbel draws
(``model.gumbel_noise``), the home seat's before the away seat's. Tests may
hand in the scenarios and the draws (``rollout(scenarios=, noise=)``);
that is the only difference between the tested path and the main one.
"""
from __future__ import annotations

import copy
import os
import threading
import time
import warnings
from typing import Callable, Optional

import numpy as np
import torch

from ...lib import actions as ACT
from ...lib import features as F
from ...obs import get_registry
from .core import WINNER_AWAY, WINNER_HOME, EnvConfig, lane_where, micro_legal_mask, reset, step
from .obs import observe
from .scenario import Scenario, ScenarioConfig, ScenarioGenerator, make_generator, table

# Per-action-type head relevance: actions_mask[head][t, b] =
# LUT[head][action_type] * step_mask, the host actor's per-step masks from
# the ACTIONS spec flags.
_HEAD_LUT = {
    "action_type": np.ones(ACT.NUM_ACTIONS, np.float32),
    "delay": np.ones(ACT.NUM_ACTIONS, np.float32),
    "queued": ACT.QUEUED_MASK.astype(np.float32),
    "selected_units": ACT.SELECTED_UNITS_MASK.astype(np.float32),
    "target_unit": ACT.TARGET_UNIT_MASK.astype(np.float32),
    "target_location": ACT.TARGET_LOCATION_MASK.astype(np.float32),
}
_MICRO_LEGAL = micro_legal_mask()

# host reads a device-pure window must not make
HOST_READS = ("item", "tolist", "cpu", "numpy", "__bool__", "__int__", "__float__", "__index__")


def device_pure_report(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and report what left the device.

    Every host read of a tensor on this thread (``HOST_READS``) is recorded
    by name, and on CUDA the call runs under
    ``torch.cuda.set_sync_debug_mode("warn")``, each synchronizing CUDA
    call recorded as ``sync at <file>:<line>`` of the Python line making
    it. Returns ``{"pure": bool, "offending": [names]}`` and keeps ``fn``'s
    result under ``"result"``."""
    found: list = []
    me = threading.get_ident()
    real = {name: getattr(torch.Tensor, name) for name in HOST_READS}

    def spy(name):
        def read(self, *a, **kw):
            if threading.get_ident() == me:
                found.append(name)
            return real[name](self, *a, **kw)
        return read

    cuda = torch.cuda.is_available()
    mode = torch.cuda.get_sync_debug_mode() if cuda else 0
    try:
        for name in HOST_READS:
            setattr(torch.Tensor, name, spy(name))
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            if cuda:
                torch.cuda.set_sync_debug_mode("warn")
            result = fn(*args, **kwargs)
    finally:
        if cuda:
            torch.cuda.set_sync_debug_mode(mode)
        for name, method in real.items():
            setattr(torch.Tensor, name, method)
    found += [f"sync at {os.path.basename(w.filename)}:{w.lineno}" for w in caught
              if "called a synchronizing CUDA operation" in str(w.message)]
    return {"pure": not found, "offending": found, "result": result}


def upload_tables(device) -> None:
    """Every lookup table a window reads, copied to ``device`` ahead of the
    first window, so that no window makes a host copy (``scenario.table``
    caches them)."""
    from . import core, scenario

    arrays = [v for mod in (scenario, core) for v in vars(mod).values() if isinstance(v, np.ndarray)]
    for array in arrays + list(_HEAD_LUT.values()) + [_MICRO_LEGAL]:
        table(array, device)


def _stack(trees):
    """A list of equal trees (dicts, tuples, tensors) -> one tree of
    tensors stacked on a new leading axis."""
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    if isinstance(first, tuple):
        return tuple(_stack(list(xs)) for xs in zip(*trees))
    return torch.stack(trees)


def _zero_lanes(hidden, done):
    return tuple((h.masked_fill(done[:, None], 0.0), c.masked_fill(done[:, None], 0.0))
                 for h, c in hidden)


class AnakinRunner:
    """On-device rollout producer for one card.

    Parameters
    ----------
    model: the port's ``Model`` (flagship or smoke config), the bootstrap
        policy; ``rollout`` takes the live one. Hidden dims come from
        ``model.cfg``.
    batch_size: B, the number of env lanes.
    unroll_len: T, steps per trajectory window.
    restrict_micro: confine action_type to the micro-battle vocabulary
        through ``sample_action``'s legal mask (the env ignores macro
        actions; this keeps probability mass on executable commands).
    teacher_apply: optional ``(obs, hidden, action, sun) -> logits`` for a
        real teacher; default self-teacher.
    opponent_seat: the two-policy rollout: ``rollout`` then takes a frozen
        ``opponent_model`` driving the away team and the batch carries
        ``match_result``.
    device: where the lanes live (default: the model's device).
    """

    def __init__(self, model, batch_size: int, unroll_len: int,
                 env_cfg: EnvConfig = EnvConfig(),
                 scenario_cfg: Optional[ScenarioConfig] = None,
                 seed: int = 0, restrict_micro: bool = True,
                 teacher_apply: Optional[Callable] = None,
                 opponent_seat: bool = False, device=None):
        self.model = model
        self.B = int(batch_size)
        self.T = int(unroll_len)
        self.env_cfg = env_cfg
        self.gen = ScenarioGenerator(
            scenario_cfg if scenario_cfg is not None
            else ScenarioConfig(units_per_squad=env_cfg.units_per_squad))
        if self.gen.cfg.units_per_squad != env_cfg.units_per_squad:
            raise ValueError(
                "scenario_cfg.units_per_squad must match env_cfg "
                f"({self.gen.cfg.units_per_squad} != {env_cfg.units_per_squad})")
        self.device = torch.device(device) if device is not None else next(model.parameters()).device
        lstm = model.cfg["encoder"]["core_lstm"]
        self._hidden_size = int(lstm["hidden_size"])
        self._hidden_layers = int(lstm["num_layers"])
        upload_tables(self.device)
        self._legal = table(_MICRO_LEGAL, self.device) if restrict_micro else None
        self._teacher_apply = teacher_apply
        self._seed = seed
        self.generator = make_generator(seed, self.device)
        self.opponent_seat = bool(opponent_seat)

    # ---------------------------------------------------------------- carry
    def _zero_hidden(self):
        z = torch.zeros(self.B, self._hidden_size, device=self.device)
        return tuple((z, z) for _ in range(self._hidden_layers))

    def init_carry(self, scenarios: Optional[Scenario] = None):
        """(states, hidden): B env lanes reset on ``scenarios`` (else drawn
        from the runner's generator) and zero LSTM carries. With the away
        seat: (states, hidden, opp_hidden)."""
        scn = scenarios if scenarios is not None else self.gen.batch(self.B, self.generator)
        states = reset(self.env_cfg, scn)
        if self.opponent_seat:
            return states, self._zero_hidden(), self._zero_hidden()
        return states, self._zero_hidden()

    # -------------------------------------------------------------- rollout
    def _sample(self, model, obs, hidden, noise):
        return model.sample_action(
            obs["spatial_info"], obs["entity_info"], obs["scalar_info"], obs["entity_num"], hidden,
            noise=noise, generator=None if noise is not None else self.generator,
            legal_mask=self._legal)

    def _emit_y(self, out, obs, hid, st, rew, done, step_mask):
        """One step's learner-batch slice (home perspective)."""
        action = out["action_info"]
        sun = out["selected_units_num"]
        teacher = (self._teacher_apply(obs, hid, action, sun) if self._teacher_apply is not None
                   else out["logit"])
        zero = torch.zeros(self.B, device=self.device)
        at = action["action_type"].long()
        return {
            "obs": obs,
            "action_info": action,
            "selected_units_num": sun,
            "behaviour_logp": {k: v * (step_mask[:, None] if v.dim() == 2 else step_mask)
                               for k, v in out["action_logp"].items()},
            "teacher_logit": teacher,
            "reward": {
                "winloss": rew["winloss"][:, 0] * step_mask,
                "battle": rew["battle"][:, 0] * step_mask,
                "build_order": zero, "built_unit": zero, "effect": zero, "upgrade": zero,
            },
            "step": (st.t * self.env_cfg.loops_per_step).float(),
            "done": done.float(),
            "mask": {
                "actions_mask": {k: table(lut, self.device)[at] * step_mask
                                 for k, lut in _HEAD_LUT.items()},
                "build_order_mask": zero,
                "built_unit_mask": zero,
                "effect_mask": step_mask,
                "cum_action_mask": step_mask,
                "step_mask": step_mask,
            },
        }

    def _window(self, model, carry, opponent_model, scenarios, noise):
        cfg = self.env_cfg
        opp = opponent_model is not None
        states, hidden = carry[0], carry[1]
        # window boundary: finished lanes get fresh scenarios and zero carry
        fresh = reset(cfg, scenarios if scenarios is not None else self.gen.batch(self.B, self.generator))
        d = states.done
        states = lane_where(d, fresh, states)
        hidden = _zero_lanes(hidden, d)
        opp_hidden = _zero_lanes(carry[2], d) if opp else None
        hidden0 = hidden

        ys = []
        for t in range(self.T):
            noise_home, noise_away = (None, None) if noise is None else (
                noise[t] if opp else (noise[t], None))
            prev_done = states.done
            obs = observe(cfg, states, 0)
            out = self._sample(model, obs, hidden, noise_home)
            if opp:
                out_away = self._sample(opponent_model, observe(cfg, states, 1), opp_hidden, noise_away)
                nst, rew, done, winner = step(cfg, states, out["action_info"], out["selected_units_num"],
                                              out_away["action_info"], out_away["selected_units_num"])
                opp_hidden = out_away["hidden_state"]
            else:
                nst, rew, done, winner = step(cfg, states, out["action_info"], out["selected_units_num"])
            y = self._emit_y(out, obs, hidden, states, rew, done, (~prev_done).float())
            if opp:
                y["match_winner"] = winner
                y["match_finished"] = done & ~prev_done
            ys.append(y)
            states, hidden = nst, out["hidden_state"]

        ys = _stack(ys)
        batch = self._assemble_batch(observe(cfg, states, 0), hidden0, ys)
        if opp:
            batch["match_result"] = {"winner": ys["match_winner"], "finished": ys["match_finished"],
                                     "steps": ys["step"]}
            return (states, hidden, opp_hidden), batch
        return (states, hidden), batch

    def _assemble_batch(self, boot, hidden0, ys):
        obs_full = _cat_tree(ys["obs"], boot)
        sun = ys["selected_units_num"]
        return {
            "spatial_info": obs_full["spatial_info"],
            "entity_info": obs_full["entity_info"],
            "scalar_info": obs_full["scalar_info"],
            "entity_num": obs_full["entity_num"],
            "hidden_state": hidden0,
            "action_info": ys["action_info"],
            "selected_units_num": sun,
            "behaviour_logp": ys["behaviour_logp"],
            "teacher_logit": ys["teacher_logit"],
            "reward": ys["reward"],
            "step": ys["step"],
            "done": ys["done"],
            "mask": dict(ys["mask"], selected_units_mask=(
                torch.arange(F.MAX_SELECTED_UNITS_NUM, device=self.device) < sun[..., None])),
            # read on the host by the learner (staleness): made there
            "model_last_iter": np.zeros(self.B, np.float32),
        }

    def rollout(self, model, carry, opponent_model=None, scenarios: Optional[Scenario] = None,
                noise=None):
        """One window: (new carry, learner batch [T(+1), B, ...] on the
        device). With ``opponent_seat``, ``opponent_model`` drives the away
        team and the batch gains a ``match_result`` leaf (the loader strips
        it before the learner sees the batch). ``scenarios`` (B fresh
        lanes) and ``noise`` (T draws, each a dict per head, or with the
        away seat a (home, away) pair) replace the generator's draws."""
        if self.opponent_seat and opponent_model is None:
            raise ValueError("an opponent_seat runner needs opponent_model")
        if not self.opponent_seat and opponent_model is not None:
            raise ValueError("construct AnakinRunner(opponent_seat=True) to pass opponent_model")
        with torch.no_grad():
            return self._window(model, carry, opponent_model, scenarios, noise)

    def purity_report(self, model, carry, opponent_model=None) -> dict:
        """``device_pure_report`` of one whole window from ``carry``."""
        report = device_pure_report(self.rollout, model, carry, opponent_model)
        report.pop("result")
        return report


def _cat_tree(steps, boot):
    """Observations [T, B, ...] and the bootstrap [B, ...] -> [T+1, B, ...]."""
    if isinstance(steps, dict):
        return {k: _cat_tree(steps[k], boot[k]) for k in steps}
    return torch.cat([steps, boot[None]])


class AnakinDataLoader:
    """Iterator feeding ``RLLearner.set_dataloader`` from an AnakinRunner.

    Each window runs the live model (``model_provider()``, e.g. the
    learner's; the runner's model until it gives one), so the rollout is
    on-policy from the first step on. Batches stay on the device end to end:
    the learner trains on them without a host round trip (only
    ``model_last_iter`` lies on the host).

    With an ``opponent_seat`` runner, ``opponent_provider`` supplies the
    frozen away-team model each window (a league snapshot; by default a
    frozen copy of the runner's model taken at the first window, the
    initial policy). The per-lane episode outcomes are stripped into a
    results buffer; ``drain_results()`` hands them to the league loop.
    """

    def __init__(self, runner: AnakinRunner,
                 model_provider: Optional[Callable] = None,
                 opponent_provider: Optional[Callable] = None):
        self.runner = runner
        self._model_provider = model_provider or (lambda: None)
        self._opponent_provider = opponent_provider or (lambda: None)
        self._frozen = None
        self._carry = None
        self._results: list = []
        reg = get_registry()
        reg.gauge("distar_rollout_plane_backend",
                  "active rollout-plane backend (1 = active)",
                  backend="anakin").set(1)
        self._g_rate = reg.gauge(
            "distar_anakin_env_steps_per_s",
            "fused-loop environment steps per wall second")
        self._c_batches = reg.counter(
            "distar_anakin_batches_total", "trajectory windows produced")
        self._c_episodes = reg.counter(
            "distar_env_episodes_total", "jaxenv episodes finished",
            backend="anakin")
        self._h_window = reg.histogram(
            "distar_anakin_window_seconds", "wall time per fused window")

    def _model(self):
        live = self._model_provider()
        return live if live is not None else self.runner.model

    def _opponent_model(self):
        frozen = self._opponent_provider()
        if frozen is not None:
            return frozen
        if self._frozen is None:
            self._frozen = copy.deepcopy(self.runner.model).requires_grad_(False)
        return self._frozen

    def drain_results(self) -> list:
        """Episode outcomes since the last drain (away-seat windows only):
        ``[{"winner": "home"|"away"|"draw", "steps": n}]`` in finish order,
        the league learner's match-report feed."""
        out, self._results = self._results, []
        return out

    def __iter__(self):
        return self

    def __next__(self):
        if self._carry is None:
            self._carry = self.runner.init_carry()
        t0 = time.perf_counter()
        try:
            if self.runner.opponent_seat:
                self._carry, batch = self.runner.rollout(
                    self._model(), self._carry, opponent_model=self._opponent_model())
                ended = self._collect_results(batch.pop("match_result"))
            else:
                self._carry, batch = self.runner.rollout(self._model(), self._carry)
                # the one deliberate host read a window, after it closes,
                # for honest wall-clock metrics
                ended = int(batch["done"][-1].sum())
        except Exception:
            # a failure mid-window leaves a carry of unknown state; drop it
            # so a supervised restart re-initialises
            self._carry = None
            raise
        dt = max(time.perf_counter() - t0, 1e-9)
        self._g_rate.set(self.runner.B * self.runner.T / dt)
        self._h_window.observe(dt)
        self._c_batches.inc()
        if ended:
            self._c_episodes.inc(ended)
        return batch

    def _collect_results(self, match_result: dict) -> int:
        """The outcome leaves as host records (the one host read an
        away-seat window makes, in place of the metrics read)."""
        finished = match_result["finished"].cpu().numpy()  # [T, B] bool
        winner = match_result["winner"].cpu().numpy()      # [T, B] i32
        steps = match_result["steps"].cpu().numpy()        # [T, B] f32
        names = {WINNER_HOME: "home", WINNER_AWAY: "away"}
        for t, b in zip(*np.nonzero(finished)):
            self._results.append({"winner": names.get(int(winner[t, b]), "draw"),
                                  "steps": float(steps[t, b])})
        return int(finished.sum())
