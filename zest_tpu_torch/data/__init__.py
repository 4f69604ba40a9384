"""Host-side inputs of the port (NumPy and PIL): the real-data loaders, the
synthetic scene, the wander path's poses and the training loop's prefetch
thread.

``dataset_dict`` maps each ``dataset_name`` to its loader, as
``zest_tpu.data.dataset_dict`` does; each loader's module is imported on
first use."""


def _lazy(name):
    def load(*a, **k):
        if name == "nsff":
            from .nsff import NSFFDataset
            return NSFFDataset(*a, **k)
        if name == "llff":
            from .llff import LLFFDataset
            return LLFFDataset(*a, **k)
        if name == "dtu":
            from .dtu import DTUDataset
            return DTUDataset(*a, **k)
        if name == "neural3Dvideo":
            from .neural3dvideo import Neural3DVideoDataset
            return Neural3DVideoDataset(*a, **k)
        if name == "synthetic":
            from .synthetic import SyntheticDataset
            return SyntheticDataset(*a, **k)
        raise KeyError(name)
    return load


dataset_dict = {name: _lazy(name)
                for name in ("dtu", "llff", "neural3Dvideo", "nsff", "synthetic")}
