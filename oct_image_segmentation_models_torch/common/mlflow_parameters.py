"""MLflow run parameters, counterpart of the JAX package's
``common/mlflow_parameters.py``."""

from .utils import get_timestamp


class MLflowParameters:
    def __init__(
        self,
        tracking_uri: str = "mlruns",
        username: str = None,
        password: str = None,
        experiment: str = None,
    ) -> None:
        self.tracking_uri = tracking_uri
        self.username = username
        self.password = password
        self.experiment = experiment or f"experiment-{get_timestamp()}"
