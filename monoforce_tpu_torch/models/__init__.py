from monoforce_tpu_torch.models.terrain_encoder.lss import LiftSplatShoot

__all__ = ["LiftSplatShoot"]
