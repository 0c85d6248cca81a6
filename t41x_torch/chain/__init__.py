from t41x_torch.chain.rx import (  # noqa: F401
    ChainSpec,
    ChannelParams,
    RxChain,
    RxState,
    default_params,
)
