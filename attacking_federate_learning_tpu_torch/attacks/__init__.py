from attacking_federate_learning_tpu_torch.attacks.alie import (  # noqa: F401
    DriftAttack, paper_z
)
from attacking_federate_learning_tpu_torch.attacks.base import (  # noqa: F401
    Attack, AttackContext, NoAttack, cohort_stats, delivered_cohort_stats,
    masked_cohort_stats
)
from attacking_federate_learning_tpu_torch.attacks.baselines import (  # noqa: F401
    GaussianNoiseAttack, SignFlipAttack
)
from attacking_federate_learning_tpu_torch.attacks.minmax import (  # noqa: F401
    MinMaxAttack, MinSumAttack
)
from attacking_federate_learning_tpu_torch.utils.plugins import Registry

# Factories with the uniform signature (cfg, dataset, device) -> Attack, the
# JAX package's registry (attacks/__init__.py there) with the device the
# backdoor's poison set and shadow net live on.
ATTACKS = Registry("attack")
ATTACKS.register("none", lambda cfg, dataset=None, device="cuda": NoAttack())
ATTACKS.register("alie", lambda cfg, dataset=None, device="cuda":
                 DriftAttack(cfg.num_std))


def _make_backdoor(cfg, dataset=None, device="cuda"):
    from attacking_federate_learning_tpu_torch.attacks.backdoor import (
        BackdoorAttack
    )
    return BackdoorAttack(cfg, dataset=dataset, device=device)


def _make_backdoor_timed(cfg, dataset=None, device="cuda"):
    from attacking_federate_learning_tpu_torch.attacks.backdoor import (
        TimedBackdoorAttack
    )
    return TimedBackdoorAttack(cfg, dataset=dataset, device=device)


ATTACKS.register("backdoor", _make_backdoor)
ATTACKS.register("backdoor_timed", _make_backdoor_timed)
ATTACKS.register("signflip", lambda cfg, dataset=None, device="cuda":
                 SignFlipAttack(cfg.num_std))
ATTACKS.register("noise", lambda cfg, dataset=None, device="cuda":
                 GaussianNoiseAttack(cfg.num_std, seed=cfg.seed))
ATTACKS.register("minmax", lambda cfg, dataset=None, device="cuda":
                 MinMaxAttack(cfg.num_std, direction=cfg.attack_direction))
ATTACKS.register("minsum", lambda cfg, dataset=None, device="cuda":
                 MinSumAttack(cfg.num_std, direction=cfg.attack_direction))


def make_attacker(cfg, dataset=None, name=None, device="cuda"):
    """Attack selection mirroring reference main.py:44-54: a backdoor option
    picks BackdoorAttack, otherwise ALIE DriftAttack."""
    if name is None:
        name = "backdoor" if cfg.backdoor else "alie"
    return ATTACKS[name](cfg, dataset=dataset, device=device)
