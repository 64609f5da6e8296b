from metrics_tpu_torch.functional.classification.accuracy import accuracy
from metrics_tpu_torch.functional.classification.cohen_kappa import cohen_kappa
from metrics_tpu_torch.functional.classification.confusion_matrix import confusion_matrix
from metrics_tpu_torch.functional.classification.dice import dice, dice_score
from metrics_tpu_torch.functional.classification.f_beta import f1_score, fbeta_score
from metrics_tpu_torch.functional.classification.hamming import hamming_distance
from metrics_tpu_torch.functional.classification.jaccard import jaccard_index
from metrics_tpu_torch.functional.classification.matthews_corrcoef import matthews_corrcoef
from metrics_tpu_torch.functional.classification.precision_recall import precision, precision_recall, recall
from metrics_tpu_torch.functional.classification.specificity import specificity
from metrics_tpu_torch.functional.classification.stat_scores import stat_scores

__all__ = [
    "accuracy",
    "cohen_kappa",
    "confusion_matrix",
    "dice",
    "dice_score",
    "f1_score",
    "fbeta_score",
    "hamming_distance",
    "jaccard_index",
    "matthews_corrcoef",
    "precision",
    "precision_recall",
    "recall",
    "specificity",
    "stat_scores",
]
