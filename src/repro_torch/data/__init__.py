from repro_torch.data.surveys import (  # noqa: F401
    ICLBatch,
    ICLDraw,
    SurveyConfig,
    SurveyData,
    gather_icl_batch,
    make_survey_data,
    sample_icl_batch,
    sample_icl_batches,
    sample_icl_indices,
    split_groups,
)
from repro_torch.data.embeddings import (  # noqa: F401
    BackboneEmbedder,
    StubEmbedder,
)
from repro_torch.data.lm_data import (  # noqa: F401
    LMDataConfig,
    synthetic_lm_batches,
)
