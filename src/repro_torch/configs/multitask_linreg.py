"""The paper's own workload: m=100 linear least-squares tasks, d=100,
10-NN binary relatedness graph, n=500 samples/task (Appendix I). Same values
as the JAX package's ``multitask_linreg``."""
import dataclasses


@dataclasses.dataclass(frozen=True)
class LinRegConfig:
    name: str = "multitask-linreg"
    family: str = "linear"
    num_tasks: int = 100
    dim: int = 100
    train_per_task: int = 500
    knn: int = 10
    num_clusters: int = 10
    lipschitz: float = 8.0  # loss-gradient bound proxy used by stepsize rules

    def validate(self) -> None:
        if not self.num_tasks > self.knn >= 1:
            raise ValueError(
                f"need num_tasks > knn >= 1, got {self.num_tasks} and {self.knn}"
            )


CONFIG = LinRegConfig()


def smoke() -> LinRegConfig:
    return dataclasses.replace(CONFIG, num_tasks=12, dim=10, train_per_task=40, knn=3)
