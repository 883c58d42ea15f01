from repro_torch.sim.profiles import calibrate_from_engine

__all__ = ["calibrate_from_engine"]
