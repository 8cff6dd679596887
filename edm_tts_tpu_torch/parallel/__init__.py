"""The multi-device layer (counterpart of edm_tts_tpu/parallel): process
groups (``dist``), the (data, fsdp, model[, sequence]) layout of the ranks
(``mesh``) and Megatron tensor parallelism of the Conformer blocks
(``tensor``) and GPipe pipeline parallelism over a ``pipe`` axis
(``pipeline``). ZeRO-2 is ``train/optim.py::AdamW``, ring attention
``ops/ring_attention.py``, and checkpoints across topologies
``train/checkpoint.py`` with the trainers' gathered state."""

from edm_tts_tpu_torch.parallel.dist import (
    all_gather_metrics,
    barrier,
    global_mean_metrics,
    initialize,
    process_info,
)
from edm_tts_tpu_torch.parallel.mesh import (
    BATCH,
    DATA_AXIS,
    FSDP_AXIS,
    MODEL_AXIS,
    PIPE_AXIS,
    SEQUENCE_AXIS,
    Mesh,
    ambient_mesh,
    make_hybrid_mesh,
    make_mesh,
    make_pipe_mesh,
    sum_parts,
)
from edm_tts_tpu_torch.parallel.pipeline import (
    Elsewhere,
    PipelinePlan,
    micro_rows,
    pipeline_apply,
    reduce_gradients,
    split_stages,
)
