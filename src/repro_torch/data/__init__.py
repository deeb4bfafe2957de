from repro_torch.data.surveys import (  # noqa: F401
    ICLBatch,
    SurveyConfig,
    SurveyData,
    make_survey_data,
    sample_icl_batch,
    sample_icl_batches,
    split_groups,
)
