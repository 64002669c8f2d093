"""League-RL loss: per-head V-trace PG + UPGO + TD(lambda) critics + entropy
+ teacher KL (+ the optional DAPO successive-policy KL).

Counterpart of ``distar_tpu.losses.rl_loss`` with the same config, weights
and info keys. Input layout (time-major):

  target_logit[head]      [T, B, ...]      learner policy logits
  value[field]            [T+1, B]         baseline values
  action_log_prob[head]   [T, B] / [T,B,S] behaviour log-probs
  teacher_logit[head]     [T, B, ...]
  action[head]            [T, B] / [T,B,S]
  reward[field]           [T, B]
  step                    [T, B]           game steps
  mask:
    actions_mask[head]    [T, B]   per-step head applicability
    selected_units_mask   [T, B, S]
    step_mask             [T, B]   1 real step / 0 pad step (optional)
    build_order_mask, built_unit_mask, effect_mask, cum_action_mask  [T, B]
  done                    [T, B]   1 from the terminal step onward (optional)
  entity_num              [T, B]   for entropy normalisation
  selected_units_num      [T, B]

The JAX package runs one V-trace recursion per (field, head) pair, 36 of T
steps each, and one lambda-return recursion per field; here the pairs, and
the fields, are stacked along a batch axis and run as one recursion each,
with the same arithmetic per element. Every advantage, the UPGO
base and the lambda-returns are computed from detached inputs (the JAX
package's ``stop_gradient``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..ops import generalized_lambda_returns, upgo_returns, vtrace_advantages

HEADS = ("action_type", "delay", "queued", "selected_units", "target_unit", "target_location")
# heads whose losses are always active (the rest gate on actions_mask)
ALWAYS_ON = ("action_type", "delay")
# the reward/value fields of the info grid (pg/{field}/{head}, td/{field},
# reward/{field}, value/{field})
REWARD_FIELDS = ("winloss", "build_order", "built_unit", "effect", "upgrade", "battle")
# loss-term prefixes of the info dict ("{term}/total" and, for the per-head
# terms, "{term}/{head}")
LOSS_TERMS = ("pg", "upgo", "td", "entropy", "kl", "dapo")
FIELD_MASKS = {"build_order": "build_order_mask", "built_unit": "built_unit_mask", "effect": "effect_mask"}


def _default_head_weights(selected_units: float = 0.01) -> Dict[str, float]:
    return {h: (selected_units if h == "selected_units" else 1.0) for h in HEADS}


@dataclasses.dataclass(frozen=True)
class ReinforcementLossConfig:
    """Mirrors default_reinforcement_loss.yaml."""

    baseline_weights: Tuple[Tuple[str, float], ...] = (
        ("winloss", 10.0), ("build_order", 0.0), ("built_unit", 0.0),
        ("effect", 0.0), ("upgrade", 0.0), ("battle", 0.0),
    )
    pg_weights: Tuple[Tuple[str, float], ...] = (
        ("winloss", 1.0), ("build_order", 0.0), ("built_unit", 0.0),
        ("effect", 0.0), ("upgrade", 0.0), ("battle", 0.0),
    )
    upgo_weight: float = 1.0
    kl_weight: float = 0.02
    action_type_kl_weight: float = 0.1
    entropy_weight: float = 1e-4
    dapo_weight: float = 0.0
    gammas: Tuple[Tuple[str, float], ...] = (
        ("winloss", 1.0), ("build_order", 1.0), ("built_unit", 1.0),
        ("effect", 1.0), ("upgrade", 1.0), ("battle", 0.997),
    )
    td_lambda: float = 0.8
    vtrace_lambda: float = 1.0
    pg_gamma: float = 1.0  # the reference passes gamma=1.0 into the PG vtrace
    action_type_kl_steps: int = 2400
    dapo_steps: int = 2400
    use_dapo: bool = False
    only_update_value: bool = False
    selected_units_head_weight: float = 0.01

    def head_weights(self) -> Dict[str, float]:
        return _default_head_weights(self.selected_units_head_weight)


def _gather(logp, action):
    return logp.gather(-1, action[..., None].long())[..., 0]


def pg_advantages(clipped_rhos: Dict[str, torch.Tensor], rewards: Dict[str, torch.Tensor],
                  values: Dict[str, torch.Tensor], fields, cfg: ReinforcementLossConfig
                  ) -> Dict[Tuple[str, str], torch.Tensor]:
    """The detached V-trace advantage [T, B] of every (field, head) pair, all
    pairs in one recursion: rhos [T, 1, H, B] against rewards [T, F, 1, B]
    and values [T+1, F, 1, B]."""
    with torch.no_grad():
        rho = torch.stack([clipped_rhos[h] for h in HEADS], dim=1)[:, None]
        r = torch.stack([rewards[f].float() for f in fields], dim=1)[:, :, None]
        v = torch.stack([values[f] for f in fields], dim=1)[:, :, None]
        adv = vtrace_advantages(rho, rho, r, v, gammas=cfg.pg_gamma, lambda_=cfg.vtrace_lambda)
    return {(f, h): adv[:, i, j] for i, f in enumerate(fields) for j, h in enumerate(HEADS)}


def td_returns(rewards: Dict[str, torch.Tensor], values: Dict[str, torch.Tensor], fields,
               gammas: Dict[str, float], td_lambda: float) -> Dict[str, torch.Tensor]:
    """The detached lambda-returns [T, B] of every field, all fields in one
    recursion: rewards [T, F, B], each field's gamma along F."""
    with torch.no_grad():
        r = torch.stack([rewards[f].float() for f in fields], dim=1)
        v = torch.stack([values[f] for f in fields], dim=1)
        g = torch.tensor([gammas[f] for f in fields], dtype=r.dtype, device=r.device)
        ret = generalized_lambda_returns(r, g[None, :, None].expand_as(r), v, td_lambda)
    return {f: ret[:, i] for i, f in enumerate(fields)}


def compute_rl_loss(
    inputs: Dict,
    cfg: ReinforcementLossConfig = ReinforcementLossConfig(),
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(total loss, info): info holds every term's 0-d tensor, attached to
    the graph as the JAX package's are (the learner reads ``td/total`` for
    the value-pretrain gate)."""
    target_logit = inputs["target_logit"]
    values = dict(inputs["value"])
    behaviour_logp = inputs["action_log_prob"]
    teacher_logit = inputs["teacher_logit"]
    masks = inputs["mask"]
    actions = inputs["action"]
    rewards = inputs["reward"]
    steps = inputs["step"]
    entity_num = inputs["entity_num"]
    su_mask = masks["selected_units_mask"]

    info: Dict[str, torch.Tensor] = {}

    vdtype = values[next(iter(values))].dtype
    # step_mask: 1 on real steps, 0 on the pad steps after a mid-window
    # episode end; pad steps contribute to no term and their values are 0
    step_mask = masks.get("step_mask")
    if step_mask is None:
        step_mask = torch.ones_like(rewards["winloss"], dtype=vdtype)
    else:
        step_mask = step_mask.to(vdtype)
    # zero the bootstrap value when the episode ended in this window
    done = inputs.get("done")
    if done is None:
        not_done = (rewards["winloss"][-1] == 0).to(vdtype)
    else:
        not_done = 1.0 - done[-1].to(vdtype)
    for field in values:
        v = values[field]
        # out of place: autograd keeps the tower's output as it was
        values[field] = torch.cat([v[:-1] * step_mask, (v[-1] * not_done)[None]], dim=0)

    # per-head distribution prep
    target_logp_full: Dict[str, torch.Tensor] = {}
    target_prob_full: Dict[str, torch.Tensor] = {}
    target_action_logp: Dict[str, torch.Tensor] = {}
    clipped_rhos: Dict[str, torch.Tensor] = {}
    for head in HEADS:
        logp_full = F.log_softmax(target_logit[head], dim=-1)
        target_logp_full[head] = logp_full
        target_prob_full[head] = torch.exp(logp_full)
        alogp = _gather(logp_full, actions[head])
        blogp = behaviour_logp[head]
        if head == "selected_units":
            log_rho = torch.where(su_mask, alogp.detach() - blogp, 0.0).sum(-1)
            alogp = torch.where(su_mask, alogp, 0.0).sum(-1)
        else:
            log_rho = alogp.detach() - blogp
        target_action_logp[head] = alogp
        clipped_rhos[head] = torch.clamp(torch.exp(log_rho), max=1.0)

    head_w = cfg.head_weights()
    gammas = dict(cfg.gammas)

    # ------------------------------------------------ policy gradient (vtrace)
    pg_fields = [f for f, _ in cfg.pg_weights if f in values and f in rewards]
    advs = pg_advantages(clipped_rhos, rewards, values, pg_fields, cfg) if pg_fields else {}
    total_pg = 0.0
    for field, field_w in cfg.pg_weights:
        if field not in values or field not in rewards:
            continue
        field_pg = 0.0
        for head in HEADS:
            pg = -advs[field, head] * target_action_logp[head] * step_mask
            if head not in ALWAYS_ON:
                pg = pg * masks["actions_mask"][head]
            if field in FIELD_MASKS:
                pg = pg * masks[FIELD_MASKS[field]]
            pg = pg.mean()
            field_pg = field_pg + pg * head_w[head]
            info[f"pg/{field}/{head}"] = pg
        total_pg = total_pg + field_w * field_pg
    info["pg/total"] = total_pg

    # ------------------------------------------------------------------ UPGO
    total_upgo = 0.0
    with torch.no_grad():
        v_win = values["winloss"].detach()
        upgo_adv_base = upgo_returns(rewards["winloss"].float(), v_win) - v_win[:-1]
    for head in HEADS:
        adv = clipped_rhos[head] * upgo_adv_base
        ug = -adv * target_action_logp[head] * step_mask
        if head not in ALWAYS_ON:
            ug = ug * masks["actions_mask"][head]
        ug = ug.mean()
        total_upgo = total_upgo + ug * head_w[head]
        info[f"upgo/{head}"] = ug
    total_upgo = total_upgo * cfg.upgo_weight
    info["upgo/total"] = total_upgo

    # ---------------------------------------------------------------- critic
    total_critic = 0.0
    td_fields = [f for f, _ in cfg.baseline_weights if f in values and f in rewards]
    returns = td_returns(rewards, values, td_fields, gammas, cfg.td_lambda) if td_fields else {}
    for field, field_w in cfg.baseline_weights:
        if field not in values or field not in rewards:
            continue
        reward = rewards[field].float()
        baseline = values[field]
        td = 0.5 * torch.square(returns[field] - baseline[:-1]) * step_mask
        if field in FIELD_MASKS:
            td = td * masks[FIELD_MASKS[field]]
        td = td.mean()
        total_critic = total_critic + field_w * td
        info[f"td/{field}"] = td
        info[f"reward/{field}"] = reward.mean()
        info[f"value/{field}"] = baseline.mean()
    info["td/total"] = total_critic

    # --------------------------------------------------------------- entropy
    total_entropy_loss = 0.0
    for head in HEADS:
        ent = -target_prob_full[head] * target_logp_full[head]
        if head == "selected_units":
            # normalise by log(valid candidates + 1), average over real steps
            norm = torch.log(entity_num.float() + 1.0 + 1e-9)[..., None]
            ent = ent.sum(-1) / norm
            ent = (ent * su_mask).sum(-1) / (su_mask.sum(-1) + 1e-9)
        elif head == "target_unit":
            ent = ent.sum(-1) / (torch.log(entity_num.float() + 1.0) + 1e-9)
        else:
            ent = ent.sum(-1) / math.log(float(ent.shape[-1]))
        ent = ent * step_mask
        if head not in ALWAYS_ON:
            ent = ent * masks["actions_mask"][head]
        ent_mean = ent.mean()
        info[f"entropy/{head}"] = ent_mean
        total_entropy_loss = total_entropy_loss + -ent_mean * head_w[head]
    total_entropy_loss = total_entropy_loss * cfg.entropy_weight
    info["entropy/total"] = total_entropy_loss

    # -------------------------------------------------------------------- KL
    def _kl_terms(ref_logit):
        out = {}
        for head in HEADS:
            ref_logp = F.log_softmax(ref_logit[head], dim=-1)
            kl = (torch.exp(ref_logp) * (ref_logp - target_logp_full[head])).sum(-1)
            if head == "selected_units":
                kl = (kl * su_mask).sum(-1)
            kl = kl * step_mask
            if head not in ALWAYS_ON:
                kl = kl * masks["actions_mask"][head]
            out[head] = kl
        return out

    kls = _kl_terms(teacher_logit)
    total_kl = 0.0
    for head, kl in kls.items():
        kl_mean = kl.mean()
        total_kl = total_kl + kl_mean * head_w[head]
        info[f"kl/{head}"] = kl_mean
    at_kl = (kls["action_type"] * (steps < cfg.action_type_kl_steps) * masks["cum_action_mask"]).mean()
    total_kl = total_kl * cfg.kl_weight
    at_kl = at_kl * cfg.action_type_kl_weight
    info["kl/total"] = total_kl
    info["kl/extra_at"] = at_kl

    # ------------------------------------------------------------------ DAPO
    total_dapo = 0.0
    if cfg.use_dapo:
        dapo_kls = _kl_terms(inputs["successive_logit"])
        flag = steps < cfg.dapo_steps
        for head, kl in dapo_kls.items():
            kl_mean = (kl * flag).mean()
            total_dapo = total_dapo + kl_mean * head_w[head]
            info[f"dapo/{head}"] = kl_mean
        total_dapo = total_dapo * cfg.dapo_weight
        info["dapo/total"] = total_dapo

    if cfg.only_update_value:
        total = total_critic
    else:
        total = total_pg + total_upgo + total_critic + total_entropy_loss + total_kl + at_kl + total_dapo
    info["total_loss"] = total
    return total, info
