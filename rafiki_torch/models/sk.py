"""SkDt and SkSvm: the port's copies of the reference's sklearn zoo
entries (``rafiki_tpu/models/sk.py``), under the same names, knobs and
estimators: a decision tree and an SVM with probability calibration,
both on flattened pixels. sklearn is imported in ``create_estimator``
only."""

from __future__ import annotations

from ..model.knobs import CategoricalKnob, FixedKnob, FloatKnob, IntegerKnob
from ..model.sklearn_model import SklearnModel


class SkDt(SklearnModel):
    """Decision-tree classifier on flattened pixels."""

    @staticmethod
    def get_knob_config():
        return {
            "max_depth": IntegerKnob(2, 16),
            "criterion": CategoricalKnob(["gini", "entropy"]),
            "min_samples_leaf": IntegerKnob(1, 8),
        }

    def create_estimator(self):
        from sklearn.tree import DecisionTreeClassifier
        return DecisionTreeClassifier(
            max_depth=int(self.knobs["max_depth"]),
            criterion=str(self.knobs["criterion"]),
            min_samples_leaf=int(self.knobs["min_samples_leaf"]),
            random_state=0,
        )


class SkSvm(SklearnModel):
    """SVM (linear or RBF kernel) with probability calibration."""

    @staticmethod
    def get_knob_config():
        return {
            "C": FloatKnob(1e-2, 1e2, is_exp=True),
            "kernel": CategoricalKnob(["linear", "rbf"]),
            "max_iter": FixedKnob(1000),
        }

    def create_estimator(self):
        from sklearn.calibration import CalibratedClassifierCV
        from sklearn.svm import SVC
        svc = SVC(
            C=float(self.knobs["C"]),
            kernel=str(self.knobs["kernel"]),
            max_iter=int(self.knobs["max_iter"]),
            random_state=0,
        )
        # sklearn 1.9 deprecates SVC(probability=True) in favour of this.
        return CalibratedClassifierCV(svc, cv=3, ensemble=False)
