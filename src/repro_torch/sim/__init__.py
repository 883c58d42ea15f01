from repro_torch.sim.profiles import DEVICE_PROFILES, calibrate_from_engine, profiles_for
from repro_torch.sim.simulator import ClusterSimulator, SimInstance

__all__ = ["ClusterSimulator", "SimInstance", "DEVICE_PROFILES",
           "calibrate_from_engine", "profiles_for"]
