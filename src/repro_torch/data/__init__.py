from repro_torch.data.surveys import (  # noqa: F401
    SurveyConfig,
    SurveyData,
    make_survey_data,
    sample_icl_batch,
    split_groups,
)
