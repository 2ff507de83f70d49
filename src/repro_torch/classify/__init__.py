"""repro_torch.classify — 1-NN evaluation, the kernel SVM and
meta-parameter selection (paper Section V), nearest-centroid
classification."""
from .centroid import centroid_error_series, nearest_centroid_predict
from .crossval import (Selected, select_nu, select_radius,
                       select_theta_gamma)
from .knn import (error_rate, knn_error, knn_error_series, knn_predict,
                  loo_error)
from .svm import (svm_error, svm_fit, svm_gram_series, svm_predict,
                  svm_rws_series)
