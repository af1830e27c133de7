"""The paper's contribution: mixture-of-experts memory modeling + memory-
aware task co-location. See DESIGN.md for the TPU-fleet adaptation."""
from repro_torch.core import experts  # noqa: F401
from repro_torch.core.experts import MemoryFunction, calibrate_two_point  # noqa: F401
from repro_torch.core.predictor import (  # noqa: F401
    ANNPredictor,
    MoEPredictor,
    OraclePredictor,
    UnifiedFamilyPredictor,
)
from repro_torch.core.simulator import (  # noqa: F401
    OnlineSearchPolicy,
    OraclePolicy,
    OursPolicy,
    PairwisePolicy,
    QuasarPolicy,
    SimConfig,
    Simulator,
    make_policies,
)
from repro_torch.core.workloads import (  # noqa: F401
    AppProfile,
    spark_sim_suite,
    tpu_jobs_suite,
    training_apps,
)
