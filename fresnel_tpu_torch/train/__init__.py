from fresnel_tpu_torch.train.fit_teacher import fit_scene, init_raw

__all__ = ["fit_scene", "init_raw"]
