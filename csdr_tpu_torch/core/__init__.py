from csdr_tpu_torch.core.block import Block, Pipeline, stateless

__all__ = ["Block", "Pipeline", "stateless"]
