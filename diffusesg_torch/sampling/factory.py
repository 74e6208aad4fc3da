"""Sampler factory (counterpart of diffusesg_tpu/sampling/factory.py)."""
from __future__ import annotations

from .edm_sampler import NodeAdjEDMSampler


def get_mc_sampler(config) -> NodeAdjEDMSampler:
    if config.mcmc.name != "edm":
        raise NotImplementedError("only the EDM sampler family is supported")
    return NodeAdjEDMSampler(
        solver="heun",
        discretization="edm",
        schedule="linear",
        scaling="none",
        num_steps=config.mcmc.num_steps,
        self_condition=config.train.self_cond,
        symmetric_noise=not config.flag_sg,
        precond_self_cond_refresh_p=float(config.mcmc.get("precond_self_cond_refresh_p", 0.0)),
        # the reference's EDM-ImageNet stochasticity defaults (edm.py:25)
        S_churn=float(config.mcmc.get("s_churn", 40.0)),
        S_min=float(config.mcmc.get("s_min", 0.05)),
        S_max=float(config.mcmc.get("s_max", 50.0)),
        S_noise=float(config.mcmc.get("s_noise", 1.003)),
    )
