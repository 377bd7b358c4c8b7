from dynamo_tpu_torch.mocker.engine import MockerConfig, MockerEngine, det_next_token

__all__ = ["MockerConfig", "MockerEngine", "det_next_token"]
