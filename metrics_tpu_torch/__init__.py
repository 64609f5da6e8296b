"""metrics_tpu_torch: the PyTorch and CUDA port of metrics_tpu, for NVIDIA Hopper.

The JAX package ``metrics_tpu`` stays the reference; this package mirrors
its layout and names. Metrics are ``nn.Module``s whose states live on the
current CUDA device unless a ``device`` is given (``device="cpu"`` runs on
the CPU). The histogram of the confusion matrices, calibration bins and
retrieval query groups runs a hand-written CUDA kernel
(``csrc/bincount.cu``), built with ``nvcc`` at first use.

Ported so far: the whole classification domain (the stat-score family,
the confusion-matrix family, HammingDistance, the curve family, HingeLoss,
KLDivergence and the ranking metrics), the regression metrics, the pairwise
distances (functional), the retrieval metrics, the image-quality metrics
(PSNR, SSIM, MS-SSIM, UQI, ERGAS, SAM, D-lambda), the model-backed image
metrics (FID, KID, InceptionScore, LPIPS, with InceptionV3 and the three LPIPS
networks in ``metrics_tpu_torch.models``), detection (MeanAveragePrecision,
with the box operations and the COCO RLE codec), the text metrics (the
WER family, BLEU, SacreBLEU, chrF, TER, EED, ROUGE, SQuAD, Perplexity,
BERTScore, InfoLM; their dynamic programs in the host text library
``csrc/text_kernels.cpp``, built with g++ at first use), the audio metrics
(SNR, SI-SNR, SI-SDR, SDR, PIT, STOI, PESQ), the aggregators (Max, Min,
Sum, Cat, Mean), MetricCollection, the arithmetic of metrics
(CompositionalMetric) and the wrappers (BootStrapper, ClasswiseWrapper,
MinMaxMetric, MultioutputWrapper, MetricTracker), and state sync across
processes (``metrics_tpu_torch.parallel``): ``compute()`` reduces the states
over the ``torch.distributed`` process group, a whole suite, wrapper trees
included, in one collective. The fault, telemetry and journal planes
(``metrics_tpu_torch.ops``): classified faults with degradation ladders,
spans and latency histograms with a Prometheus and a Perfetto export, and a
crash-consistent state journal (``save_state``/``load_state``,
``MetricCollection.journal``). The functional core (``init``,
``apply_update``, ``apply_compute``, ``host_handoff``, ``FuncState``):
metric state as an explicit, epoch-stamped tree, whose update runs under
``torch.func.vmap`` and in a CUDA-graph capture, and on which BootStrapper,
MultioutputWrapper and MinMaxMetric run their clones as one program.
"""
from metrics_tpu_torch import functional, parallel
from metrics_tpu_torch.__about__ import __version__
from metrics_tpu_torch.aggregation import CatMetric, MaxMetric, MeanMetric, MinMetric, SumMetric
from metrics_tpu_torch.audio import (
    PerceptualEvaluationSpeechQuality,
    PermutationInvariantTraining,
    ScaleInvariantSignalDistortionRatio,
    ScaleInvariantSignalNoiseRatio,
    ShortTimeObjectiveIntelligibility,
    SignalDistortionRatio,
    SignalNoiseRatio,
)
from metrics_tpu_torch.classification import (
    AUC,
    AUROC,
    Accuracy,
    AveragePrecision,
    BinnedAveragePrecision,
    BinnedPrecisionRecallCurve,
    BinnedRecallAtFixedPrecision,
    CalibrationError,
    CohenKappa,
    ConfusionMatrix,
    CoverageError,
    Dice,
    F1Score,
    FBetaScore,
    HammingDistance,
    HingeLoss,
    JaccardIndex,
    KLDivergence,
    LabelRankingAveragePrecision,
    LabelRankingLoss,
    MatthewsCorrCoef,
    Precision,
    PrecisionRecallCurve,
    Recall,
    ROC,
    Specificity,
    StatScores,
)
from metrics_tpu_torch.collections import MetricCollection
from metrics_tpu_torch.detection import MeanAveragePrecision
from metrics_tpu_torch.image import (
    ErrorRelativeGlobalDimensionlessSynthesis,
    FrechetInceptionDistance,
    InceptionScore,
    KernelInceptionDistance,
    LearnedPerceptualImagePatchSimilarity,
    MultiScaleStructuralSimilarityIndexMeasure,
    PeakSignalNoiseRatio,
    SpectralAngleMapper,
    SpectralDistortionIndex,
    StructuralSimilarityIndexMeasure,
    UniversalImageQualityIndex,
)
from metrics_tpu_torch.interop import load_reference_state
from metrics_tpu_torch.metric import CompositionalMetric, Metric
from metrics_tpu_torch.regression import (
    CosineSimilarity,
    ExplainedVariance,
    MeanAbsoluteError,
    MeanAbsolutePercentageError,
    MeanSquaredError,
    MeanSquaredLogError,
    PearsonCorrCoef,
    R2Score,
    SpearmanCorrCoef,
    SymmetricMeanAbsolutePercentageError,
    TweedieDevianceScore,
    WeightedMeanAbsolutePercentageError,
)
from metrics_tpu_torch.retrieval import (
    RetrievalFallOut,
    RetrievalHitRate,
    RetrievalMAP,
    RetrievalMetric,
    RetrievalMRR,
    RetrievalNormalizedDCG,
    RetrievalPrecision,
    RetrievalPrecisionRecallCurve,
    RetrievalRecall,
    RetrievalRecallAtFixedPrecision,
    RetrievalRPrecision,
)
from metrics_tpu_torch.text import (
    BERTScore,
    BLEUScore,
    CharErrorRate,
    CHRFScore,
    ExtendedEditDistance,
    InfoLM,
    MatchErrorRate,
    Perplexity,
    ROUGEScore,
    SacreBLEUScore,
    SQuAD,
    TranslationEditRate,
    WordErrorRate,
    WordInfoLost,
    WordInfoPreserved,
)
from metrics_tpu_torch.wrappers import (
    BootStrapper,
    ClasswiseWrapper,
    MetricTracker,
    MinMaxMetric,
    MultioutputWrapper,
)

# the monitoring surface: one merged snapshot, its Prometheus text, the Perfetto trace
from metrics_tpu_torch.ops.telemetry import (  # noqa: E402
    export_trace,
    prometheus_text,
    set_telemetry,
    telemetry_snapshot,
)
from metrics_tpu_torch.parallel.sync import world_health  # noqa: E402

# the fleet plane (cross-rank snapshots, straggler attribution, the merged trace) and performance attribution
from metrics_tpu_torch.ops.fleetobs import (  # noqa: E402
    export_fleet_trace,
    fleet_perf_report,
    fleet_prometheus_text,
    fleet_snapshot,
)
from metrics_tpu_torch.ops.perf import perf_report  # noqa: E402

# the functional core: state as an epoch-stamped tree, the apply_* API under
# torch.func.vmap and CUDA-graph capture, the host_handoff seam
from metrics_tpu_torch.functional_core import (  # noqa: E402
    FuncState,
    apply_compute,
    apply_update,
    funcore_stats,
    host_handoff,
)
from metrics_tpu_torch.arena import stack_states, unstack_states  # noqa: E402

# the tenant planes: windows, decay and drift; arenas of stacked suites; the ingestion gateway;
# states sharded over a DeviceMesh
from metrics_tpu_torch.streaming import Decayed, Windowed, drift_report  # noqa: E402
from metrics_tpu_torch.arena import MetricArena, arena_stats  # noqa: E402
from metrics_tpu_torch.ingest import IngestGateway, ingest_state, ingest_stats  # noqa: E402
from metrics_tpu_torch.parallel.sharding import infer_state_pspecs, infer_state_shardings  # noqa: E402

__all__ = [
    "AUC",
    "AUROC",
    "Accuracy",
    "AveragePrecision",
    "BERTScore",
    "BLEUScore",
    "BinnedAveragePrecision",
    "BinnedPrecisionRecallCurve",
    "BinnedRecallAtFixedPrecision",
    "BootStrapper",
    "CHRFScore",
    "CalibrationError",
    "CatMetric",
    "CharErrorRate",
    "ClasswiseWrapper",
    "CohenKappa",
    "CompositionalMetric",
    "ConfusionMatrix",
    "CosineSimilarity",
    "CoverageError",
    "Decayed",
    "Dice",
    "ErrorRelativeGlobalDimensionlessSynthesis",
    "ExplainedVariance",
    "ExtendedEditDistance",
    "F1Score",
    "FBetaScore",
    "FrechetInceptionDistance",
    "FuncState",
    "HammingDistance",
    "HingeLoss",
    "InceptionScore",
    "InfoLM",
    "IngestGateway",
    "JaccardIndex",
    "KLDivergence",
    "KernelInceptionDistance",
    "LabelRankingAveragePrecision",
    "LabelRankingLoss",
    "LearnedPerceptualImagePatchSimilarity",
    "MatchErrorRate",
    "MatthewsCorrCoef",
    "MaxMetric",
    "MeanAbsoluteError",
    "MeanAbsolutePercentageError",
    "MeanAveragePrecision",
    "MeanMetric",
    "MeanSquaredError",
    "MeanSquaredLogError",
    "Metric",
    "MetricArena",
    "MetricCollection",
    "MetricTracker",
    "MinMaxMetric",
    "MinMetric",
    "MultiScaleStructuralSimilarityIndexMeasure",
    "MultioutputWrapper",
    "PeakSignalNoiseRatio",
    "PearsonCorrCoef",
    "PerceptualEvaluationSpeechQuality",
    "PermutationInvariantTraining",
    "Perplexity",
    "Precision",
    "PrecisionRecallCurve",
    "R2Score",
    "ROC",
    "ROUGEScore",
    "Recall",
    "RetrievalFallOut",
    "RetrievalHitRate",
    "RetrievalMAP",
    "RetrievalMRR",
    "RetrievalMetric",
    "RetrievalNormalizedDCG",
    "RetrievalPrecision",
    "RetrievalPrecisionRecallCurve",
    "RetrievalRPrecision",
    "RetrievalRecall",
    "RetrievalRecallAtFixedPrecision",
    "SQuAD",
    "SacreBLEUScore",
    "ScaleInvariantSignalDistortionRatio",
    "ScaleInvariantSignalNoiseRatio",
    "ShortTimeObjectiveIntelligibility",
    "SignalDistortionRatio",
    "SignalNoiseRatio",
    "SpearmanCorrCoef",
    "Specificity",
    "SpectralAngleMapper",
    "SpectralDistortionIndex",
    "StatScores",
    "StructuralSimilarityIndexMeasure",
    "SumMetric",
    "SymmetricMeanAbsolutePercentageError",
    "TranslationEditRate",
    "TweedieDevianceScore",
    "UniversalImageQualityIndex",
    "WeightedMeanAbsolutePercentageError",
    "Windowed",
    "WordErrorRate",
    "WordInfoLost",
    "WordInfoPreserved",
    "__version__",
    "apply_compute",
    "apply_update",
    "arena_stats",
    "drift_report",
    "export_fleet_trace",
    "export_trace",
    "fleet_perf_report",
    "fleet_prometheus_text",
    "fleet_snapshot",
    "funcore_stats",
    "functional",
    "host_handoff",
    "infer_state_pspecs",
    "infer_state_shardings",
    "ingest_state",
    "ingest_stats",
    "load_reference_state",
    "parallel",
    "perf_report",
    "prometheus_text",
    "set_telemetry",
    "stack_states",
    "telemetry_snapshot",
    "unstack_states",
    "world_health",
]
