"""``paddle_tpu_torch.nn.Layer`` and its containers against
``paddle_tpu.nn.Layer`` on the CPU: one network written once and built in
both packages (``build``), its structured names, traversal orders, modes,
parameter creation, state round trips, dtype moves, containers and hooks;
that every layer class of the port is a ``Layer``; and the two places
where the port takes upstream Paddle's behaviour over the reference's
(ROADMAP §C.20, §C.21)."""
import inspect

import numpy as np
import pytest
import torch

import paddle_tpu as P
import paddle_tpu_torch as T
from paddle_tpu.framework.op import raw
from paddle_tpu_torch import device as tdevice
from paddle_tpu_torch.framework import load_numpy_state


@pytest.fixture(autouse=True)
def on_cpu():
    """The port's default device set to the CPU, restored after."""
    prev = tdevice._default
    T.set_device("cpu")
    yield
    tdevice._default = prev


def build(pkg, share=False):
    """One network in ``pkg`` (``paddle_tpu`` or ``paddle_tpu_torch``):
    own parameters, a ``LayerList`` of blocks, a ``Sequential``, a
    ``LayerDict``, a ``ParameterList`` and a buffer; with ``share`` a
    parameter and a block registered twice."""
    nn = pkg.nn

    class Block(nn.Layer):
        def __init__(self):
            super().__init__()
            self.fc = nn.Linear(4, 4)
            self.norm = nn.LayerNorm(4)

        def forward(self, x):
            return self.norm(self.fc(x))

    class Net(nn.Layer):
        def __init__(self):
            super().__init__()
            self.w = self.create_parameter([3, 4])
            self.blocks = nn.LayerList([Block(), Block()])
            self.head = nn.Sequential(nn.Linear(4, 2), nn.ReLU())
            self.extra = nn.LayerDict({"a": nn.Linear(2, 2)})
            self.plist = nn.ParameterList(
                [self.create_parameter([2], is_bias=True)])
            self.register_buffer("steps", pkg.zeros([1]))
            if share:
                self.w_again = self.w
                self.alias = self.blocks[0]

        def forward(self, x):
            h = pkg.matmul(x, self.w)
            for block in self.blocks:
                h = block(h)
            return self.extra["a"](self.head(h)) + self.plist[0]

    return Net()


def np_state(layer):
    return {k: np.asarray(raw(v)) for k, v in layer.state_dict().items()}


def bridged():
    """The network in both packages, the port's carrying the reference's
    weights."""
    P.seed(3)
    ref = build(P)
    port = build(T)
    load_numpy_state(port, np_state(ref))
    return ref, port


def test_structured_names():
    ref, port = build(P), build(T)
    assert [n for n, _ in port.named_parameters()] == \
        [n for n, _ in ref.named_parameters()]
    assert [n for n, _ in port.named_buffers()] == \
        [n for n, _ in ref.named_buffers()]
    assert sorted(port.state_dict()) == sorted(ref.state_dict())
    assert port.full_name() == ref.full_name() == "net"
    assert list(port.state_dict(include_sublayers=False)) == ["w", "steps"]
    assert sorted(port.state_dict(structured_name_prefix="m.")) == \
        sorted(ref.state_dict(structured_name_prefix="m."))


def test_parameters_order_and_dedup():
    ref, port = build(P, share=True), build(T, share=True)
    got = [n for n, _ in port.named_parameters()]
    assert got == [n for n, _ in ref.named_parameters()]
    params = port.parameters()
    assert isinstance(params, list) and len(params) == len(got) == \
        len(ref.parameters())
    assert len({id(p) for p in params}) == len(params)
    assert next(params) is params[0] and next(params) is params[1]
    assert len(port.parameters(include_sublayers=False)) == \
        len(ref.parameters(include_sublayers=False)) == 1
    assert [n for n, _ in port.named_parameters(
        include_sublayers=False)] == [n for n, _ in ref.named_parameters(
            include_sublayers=False)]
    torch.optim.SGD(port.parameters(), lr=0.1)  # a list is torch's input


def test_sublayers_order_and_apply():
    ref, port = build(P), build(T)
    want = [n for n, _ in ref.named_sublayers(include_self=True)]
    assert [n for n, _ in port.named_sublayers(include_self=True)] == want
    assert [n for n, _ in port.named_sublayers(prefix="m")] == \
        [n for n, _ in ref.named_sublayers(prefix="m")]
    assert [type(s).__name__ for s in port.sublayers()] == \
        [type(s).__name__ for s in ref.sublayers()]
    assert [n for n, _ in port.named_children()] == \
        [n for n, _ in ref.named_children()]
    seen = {"ref": [], "port": []}
    ref.apply(lambda m: seen["ref"].append(type(m).__name__))
    assert port.apply(lambda m: seen["port"].append(type(m).__name__)) \
        is port
    assert seen["port"] == seen["ref"] and seen["port"][0] == "Net"


def test_train_and_eval_reach_every_sublayer():
    ref, port = build(P), build(T)
    for net in (ref, port):
        net.eval()
        assert not any(m.training for m in net.sublayers(include_self=True))
        net.train()
        assert all(m.training for m in net.sublayers(include_self=True))


def test_create_parameter_dtypes_and_initializers():
    pairs = []
    for pkg in (P, T):
        layer = pkg.nn.Layer()
        init = pkg.nn.initializer
        attr = pkg.nn.ParamAttr(initializer=init.Constant(2.0),
                                learning_rate=0.5, trainable=False)
        pairs.append([
            layer.create_parameter([30, 40]),
            layer.create_parameter([5], is_bias=True),
            layer.create_parameter([3], default_initializer=init.Constant(
                0.5)),
            layer.create_parameter([2, 2], attr=attr),
            layer.create_parameter([4], dtype="float16",
                                   default_initializer=init.Constant(1.0)),
            pkg.nn.Layer(dtype="float16").create_parameter(
                [2], default_initializer=init.Constant(3.0))])
    (xr, *ref), (xp, *port) = pairs
    assert isinstance(xp, T.nn.Parameter) and xp.trainable
    assert str(xp.dtype) == "torch.float32"
    std = np.sqrt(2.0 / (30 + 40))  # XavierNormal
    for p in (np.asarray(raw(xr)), xp.detach().numpy()):
        assert abs(p.std() / std - 1) < 0.1
    for r, p in zip(ref, port):
        np.testing.assert_array_equal(p.detach().float().numpy(),
                                      np.asarray(raw(r), np.float32))
        assert str(p.dtype) == f"torch.{np.asarray(raw(r)).dtype}"
        assert p.trainable == r.trainable
        assert p.stop_gradient == r.stop_gradient
        assert p.optimize_attr == r.optimize_attr
        assert p.persistable


def test_state_dict_round_trip_and_mismatch():
    ref, port = bridged()
    for k, v in np_state(ref).items():
        np.testing.assert_array_equal(port.state_dict()[k].numpy(), v)
    partial = {k: v for k, v in np_state(ref).items() if "blocks.1" not in k}
    partial["nope"] = np.zeros(1, np.float32)
    m_ref, u_ref = ref.set_state_dict(partial)
    m_port, u_port = port.set_state_dict(partial)
    assert sorted(m_port) == sorted(m_ref) and m_ref
    assert u_port == u_ref == ["nope"]
    assert port.load_dict(np_state(ref)) == ([], [])
    assert port.set_dict(np_state(ref)) == ([], [])
    bad = dict(np_state(ref), w=np.zeros((4, 3), np.float32))
    for net in (ref, port):
        with pytest.raises(ValueError, match="shape mismatch"):
            net.set_state_dict(bad)


def test_outputs_equal_on_bridged_weights():
    ref, port = bridged()
    x = np.random.RandomState(0).standard_normal((2, 3)).astype(np.float32)
    np.testing.assert_allclose(port(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(raw(ref(P.to_tensor(x)))),
                               rtol=1e-5, atol=1e-6)


def test_to_dtype_and_astype():
    ref, port = build(P), build(T)
    for net in (ref, port):
        assert net.to(dtype="float16") is net
    assert [str(p.dtype) for p in port.parameters()] == \
        [f"torch.{np.asarray(raw(p)).dtype}" for p in ref.parameters()]
    assert str(port.steps.dtype) == "torch.float16"
    assert port.blocks[0].fc.create_parameter([2]).dtype == torch.float16
    for net in (ref, port):
        net.astype("float32")
    assert all(p.dtype == torch.float32 for p in port.parameters())
    port.bfloat16()
    assert port.w.dtype == torch.bfloat16 and isinstance(port.w,
                                                         T.nn.Parameter)
    port.float()
    port.half()
    assert port.w.dtype == torch.float16
    assert port.to("cpu", "float32").w.dtype == torch.float32
    assert port.to(device="cpu").w.device.type == "cpu"


def test_parameter_list_and_layer_dict():
    pairs = []
    for pkg in (P, T):
        layer = pkg.nn.Layer()
        pl = pkg.nn.ParameterList([layer.create_parameter([2]),
                                   layer.create_parameter([3])])
        pl.append(layer.create_parameter([4]))
        ld = pkg.nn.LayerDict({"a": pkg.nn.Linear(2, 2)})
        ld["b"] = pkg.nn.Linear(2, 3)
        ld.update([("c", pkg.nn.Linear(3, 3))])
        popped = ld.pop("a")
        pairs.append((pl, ld, popped))
    (pr, lr, ar), (pp, lp, ap) = pairs
    assert [tuple(p.shape) for p in pp] == [tuple(p.shape) for p in pr]
    assert len(pp) == len(pr) == 3 and tuple(pp[2].shape) == (4,)
    assert [n for n, _ in pp.named_parameters()] == \
        [n for n, _ in pr.named_parameters()]
    assert list(lp.keys()) == list(lr.keys()) == ["b", "c"]
    assert [type(v).__name__ for v in lp.values()] == ["Linear", "Linear"]
    assert [k for k, _ in lp.items()] == ["b", "c"]
    assert "b" in lp and len(lp) == 2 and isinstance(ap, T.nn.Linear)
    assert sorted(lp.state_dict()) == sorted(lr.state_dict())
    lp.clear()
    lr.clear()
    assert len(lp) == len(lr) == 0


def test_forward_hooks():
    ref, port = bridged()
    x = np.ones((2, 3), np.float32)
    results = []
    for net, wrap in ((ref, P.to_tensor), (port, torch.from_numpy)):
        calls = []

        def pre(layer, inputs):
            calls.append("pre")
            return (inputs[0] * 2,)

        def post(layer, inputs, out):
            calls.append("post")
            return out + 1

        h1 = net.register_forward_pre_hook(pre)
        h2 = net.register_forward_post_hook(post)
        hooked = net(wrap(x))
        h1.remove()
        h2.remove()
        plain = net(wrap(x))
        results.append((hooked, plain, calls))
    (hr, pr, cr), (hp, pp, cp) = results
    assert cp == cr == ["pre", "post"]
    np.testing.assert_allclose(hp.detach().numpy(), np.asarray(raw(hr)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(pp.detach().numpy(), np.asarray(raw(pr)),
                               rtol=1e-5, atol=1e-6)


def test_clear_gradients_and_repr():
    port = build(T)
    port(torch.ones(2, 3)).sum().backward()
    assert all(p.grad is not None for p in port.parameters())
    port.clear_gradients()
    assert all(float(p.grad.abs().sum()) == 0 for p in port.parameters())
    port.clear_gradients(set_to_zero=False)
    assert all(p.grad is None for p in port.parameters())
    assert "in_features=4" in repr(port) and port.extra_repr() == ""


def _port_layer_classes():
    """Every ``torch.nn.Module`` subclass the port defines."""
    import importlib
    import pkgutil

    import paddle_tpu_torch

    out = {}
    for info in pkgutil.walk_packages(paddle_tpu_torch.__path__,
                                      "paddle_tpu_torch."):
        mod = importlib.import_module(info.name)
        for name, obj in vars(mod).items():
            if inspect.isclass(obj) and issubclass(obj, torch.nn.Module) \
                    and obj.__module__ == info.name:
                out[f"{info.name}.{name}"] = obj
    return out


def test_every_port_layer_class_is_a_layer():
    classes = _port_layer_classes()
    assert len(classes) > 50
    not_layers = sorted(k for k, c in classes.items()
                        if not issubclass(c, T.nn.Layer))
    assert not not_layers, not_layers


@pytest.mark.parametrize("make", [
    lambda: T.text.models.GPTForCausalLM(T.text.models.GPTConfig(
        vocab_size=11, hidden_size=16, num_hidden_layers=1,
        num_attention_heads=2, max_position_embeddings=16), device="cpu"),
    lambda: T.text.models.LlamaForCausalLM(T.text.models.LlamaConfig(
        vocab_size=11, hidden_size=16, intermediate_size=32,
        num_hidden_layers=1, num_attention_heads=2, num_key_value_heads=1,
        max_position_embeddings=16), device="cpu"),
    lambda: T.text.models.ErnieForSequenceClassification(
        T.text.models.ErnieConfig(vocab_size=11, hidden_size=16,
                                  num_hidden_layers=1, num_attention_heads=2,
                                  intermediate_size=32), device="cpu"),
    lambda: T.vision.models.resnet18(num_classes=3, device="cpu"),
    lambda: T.incubate.MoELayer(d_model=8, d_hidden=16, num_experts=2,
                                top_k=1, device="cpu"),
], ids=["gpt", "llama", "ernie", "resnet18", "moe"])
def test_models_are_layers_throughout(make):
    model = make()
    assert all(isinstance(m, T.nn.Layer) for m in model.modules())
    assert isinstance(model.parameters(), list)


def test_sublayer_non_persistable_buffer():
    """ROADMAP §C.20: the reference checks non-persistable buffers against
    the top layer's names only, so a sublayer's shows up in the parent's
    ``state_dict``; the port, as upstream Paddle, leaves it out at every
    level."""
    nets = []
    for pkg in (P, T):
        class Sub(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.register_buffer("tmp", pkg.zeros([2]),
                                     persistable=False)
                self.register_buffer("kept", pkg.zeros([2]))

        class Top(pkg.nn.Layer):
            def __init__(self):
                super().__init__()
                self.sub = Sub()

        nets.append(Top())
    ref, port = nets
    assert sorted(ref.state_dict()) == ["sub.kept", "sub.tmp"]
    assert list(ref.sub.state_dict()) == ["kept"]
    assert list(port.state_dict()) == ["sub.kept"]
    assert list(port.sub.state_dict()) == ["kept"]
    assert [n for n, _ in port.named_buffers()] == ["sub.tmp", "sub.kept"]


def test_hook_handles_stay_apart():
    """ROADMAP §C.21: the reference keys a hook by the count of hooks
    registered, so after h0 is removed h2 takes h1's key and only h2
    fires; the port's handles are unique and h1 and h2 both fire."""
    fired = {}
    for name, pkg, wrap in (("ref", P, P.to_tensor),
                            ("port", T, torch.from_numpy)):
        log = fired[name] = []
        net = pkg.nn.Linear(2, 2)
        hooks = [net.register_forward_post_hook(
            lambda layer, i, o, tag=tag: log.append(tag))
            for tag in ("h0", "h1")]
        hooks[0].remove()
        net.register_forward_post_hook(lambda layer, i, o: log.append("h2"))
        net(wrap(np.ones((1, 2), np.float32)))
    assert fired["ref"] == ["h2"]
    assert fired["port"] == ["h1", "h2"]


def test_parameter_keeps_its_attributes_through_copies():
    import copy
    import pickle

    p = T.nn.Layer().create_parameter(
        [2], attr=T.nn.ParamAttr(learning_rate=0.3, need_clip=False))
    for q in (copy.deepcopy(p), pickle.loads(pickle.dumps(p))):
        assert isinstance(q, T.nn.Parameter)
        assert q.optimize_attr == {"learning_rate": 0.3} and not q.need_clip
        assert torch.equal(q, p)
    p.stop_gradient = True
    assert not p.requires_grad and not p.trainable
