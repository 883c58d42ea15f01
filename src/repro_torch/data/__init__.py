from repro_torch.data.sharegpt_synth import MEGA_PROMPT, SHAREGPT, sample_lengths
from repro_torch.data.workload import WorkloadSpec, generate, workload_a, workload_b, workload_c

__all__ = ["SHAREGPT", "MEGA_PROMPT", "sample_lengths", "WorkloadSpec",
           "generate", "workload_a", "workload_b", "workload_c"]
