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
