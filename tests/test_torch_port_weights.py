"""The port's weight importers and exporters against the JAX package's.

Every file is built in place: AdaFace-layout state dicts from the torch IR
reference (`tests/torch_ref.py`), ArcFace `.onnx` files from the hand-written
protobuf encoder of `tests/test_onnx_import.py`, MTCNN state dicts from the
repo's detector weights. Trees and exports must equal the JAX package's
byte for byte (same keys, dtypes and bits); `FaceEmbedder` on the same
`.ckpt`/`.onnx` file gives float32 embeddings within 1e-4 in both packages
(two frameworks' convolutions sum in different orders).
"""

import numpy as np
import pytest
import torch

from facerecognitionpipeline_tpu.models import irse as jirse
from facerecognitionpipeline_tpu.models import onnx_import as jonnx
from facerecognitionpipeline_tpu.models import torch_export as jexport
from facerecognitionpipeline_tpu.models import torch_import as jimport
from facerecognitionpipeline_tpu_torch.models import irse as tirse
from facerecognitionpipeline_tpu_torch.models import onnx_import as tonnx
from facerecognitionpipeline_tpu_torch.models import torch_export as texport
from facerecognitionpipeline_tpu_torch.models import torch_import as timport
from facerecognitionpipeline_tpu_torch.models.convert import (
    backbone_state_from_jax,
    backbone_variables_from_state,
)
from facerecognitionpipeline_tpu_torch.models.layers import lecun_normal_
from tests.test_onnx_import import _IResNetRef, write_onnx
from tests.torch_ref import make_reference


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def assert_same_tree(a, b):
    """Same keys, dtypes, shapes and bits."""
    fa, fb = _flat(a), _flat(b)
    assert set(fa) == set(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert fa[k].shape == fb[k].shape, k
        assert fa[k].tobytes() == fb[k].tobytes(), k


def assert_same_statedict(a, b):
    assert set(a) == set(b)
    for k in a:
        x, y = np.asarray(a[k]), np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape and x.tobytes() == y.tobytes(), k


def _bn_noise(model, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, (torch.nn.BatchNorm2d, torch.nn.BatchNorm1d)):
                m.running_mean.copy_(0.02 * torch.randn(m.running_mean.shape, generator=g))
                m.running_var.copy_(0.5 + torch.rand(m.running_var.shape, generator=g))
                if m.affine:
                    m.weight.copy_(1.0 + 0.05 * torch.randn(m.weight.shape, generator=g))
                    m.bias.copy_(0.02 * torch.randn(m.bias.shape, generator=g))
    return model


@pytest.fixture(scope="module")
def ref_sd():
    ref = _bn_noise(make_reference((2, 2, 2, 2), use_se=False, seed=11), 1)
    return dict(ref.state_dict())


@pytest.fixture(scope="module")
def iresnet_sd():
    torch.manual_seed(1)
    ref = _bn_noise(_IResNetRef(), 2).eval()
    return {k: v.detach().numpy().astype(np.float32)
            for k, v in ref.state_dict().items() if "num_batches_tracked" not in k}


# ------------------------------------------------------------- torch import

@pytest.mark.parametrize("case", [
    "model.", "module.model.", "_orig_mod.model.", "model.module.", "fp16", "extra_keys",
])
def test_convert_statedict_trees_equal_jax(ref_sd, case):
    scope = case if case.endswith(".") else "model."
    sd = {f"{scope}{k}": (v.half() if case == "fp16" else v) for k, v in ref_sd.items()}
    if case == "extra_keys":
        sd["head.kernel"] = torch.zeros(512, 7)
        sd["model.head.m"] = torch.zeros(1)
    want = jimport.convert_statedict(jimport.strip_prefix(sd), "ir_18")
    got = timport.convert_statedict(timport.strip_prefix(sd), "ir_18")
    assert_same_tree(got, want)
    assert timport.detect_architecture(timport.strip_prefix(sd)) == "ir_18"


def test_strip_prefix_explicit_prefix_like_jax(ref_sd):
    sd = {f"net.{k}": v for k, v in list(ref_sd.items())[:5]}
    sd["other"] = torch.zeros(1)
    assert list(timport.strip_prefix(sd, "net.")) == list(jimport.strip_prefix(sd, "net."))
    assert list(timport.strip_prefix(sd, "none.")) == list(jimport.strip_prefix(sd, "none."))


def test_missing_key_names_the_key(ref_sd):
    sd = dict(ref_sd)
    del sd["output_layer.3.weight"]
    for mod in (jimport, timport):
        with pytest.raises(KeyError, match="output_layer.3.weight"):
            mod.convert_statedict(sd, "ir_18")


def test_wrong_architecture_errors_like_jax(ref_sd):
    for mod in (jimport, timport):
        with pytest.raises(KeyError, match="body."):
            mod.convert_statedict(ref_sd, "ir_50")


@pytest.mark.parametrize("units,use_se,arch", [
    ((1, 1, 1, 1), False, "ir_micro"), ((2, 2, 2, 2), False, "ir_18"),
    ((3, 4, 14, 3), True, "ir_se_50"),
])
def test_detect_architecture_like_jax(units, use_se, arch):
    sd = {k: v for k, v in make_reference(units, use_se=use_se, seed=0).state_dict().items()}
    assert timport.detect_architecture(sd) == jimport.detect_architecture(sd) == arch


def test_detect_architecture_refuses_unknown_depth(ref_sd):
    sd = {k: v for k, v in ref_sd.items() if not k.startswith("body.7.")}
    for mod in (jimport, timport):
        with pytest.raises(ValueError, match="Cannot infer"):
            mod.detect_architecture(sd)


def test_lightning_ckpt_file_trees_equal_jax(ref_sd, tmp_path):
    path = str(tmp_path / "zoo.ckpt")
    torch.save({"state_dict": {f"model.{k}": v.half() for k, v in ref_sd.items()},
                "epoch": 24, "global_step": 100000}, path)
    assert_same_tree(timport.load_adaface_checkpoint(path, "ir_18"),
                     jimport.load_adaface_checkpoint(path, "ir_18"))
    bare = str(tmp_path / "bare.pt")
    torch.save(dict(ref_sd), bare)
    assert_same_tree(timport.load_adaface_checkpoint(bare, "ir_18"),
                     jimport.load_adaface_checkpoint(bare, "ir_18"))


class _Pickled:  # a non-tensor object the safe loader refuses
    pass


def test_untrusted_pickle_refused_and_trusted_escape(ref_sd, tmp_path):
    path = str(tmp_path / "pickled.ckpt")
    torch.save({"state_dict": {f"model.{k}": v for k, v in ref_sd.items()},
                "hparams": _Pickled()}, path)
    for mod in (jimport, timport):
        with pytest.raises(ValueError, match="trusted=True"):
            mod.load_adaface_checkpoint(path, "ir_18")
    assert_same_tree(timport.load_adaface_checkpoint(path, "ir_18", trusted=True),
                     jimport.load_adaface_checkpoint(path, "ir_18", trusted=True))


# --------------------------------------------------------------- onnx import

def test_onnx_initializers_equal_jax(tmp_path, rng):
    tensors = {
        "conv1.weight": rng.normal(size=(8, 3, 3, 3)).astype(np.float32),
        "fc.bias": rng.normal(size=(16,)).astype(np.float32),
        "scalar": np.asarray([2.5], np.float32),
    }
    path = str(tmp_path / "t.onnx")
    write_onnx(path, tensors)
    got, want = tonnx.load_onnx_initializers(path), jonnx.load_onnx_initializers(path)
    assert list(got) == list(want)
    assert_same_tree(got, want)
    for k in tensors:
        np.testing.assert_array_equal(got[k], tensors[k])


def test_onnx_packed_floats_and_varint_fields():
    """float_data (field 4) packed, dims packed, an int64 and a 32-bit field
    the parser skips: both readers give the same tensor."""
    from tests.test_onnx_import import _len_field, _tag, _varint

    arr = np.arange(6, dtype=np.float32) / 7
    dims = _varint(2) + _varint(3)
    body = _len_field(1, dims) + _tag(2, 0) + _varint(1)
    body += _len_field(4, arr.astype("<f4").tobytes()) + _len_field(8, b"w")
    body += _tag(13, 1) + (7).to_bytes(8, "little") + _tag(14, 5) + (3).to_bytes(4, "little")
    for mod in (jonnx, tonnx):
        name, out = mod._parse_tensor(body)
        assert name == "w" and out.shape == (2, 3)
        np.testing.assert_array_equal(out, arr.reshape(2, 3))
    assert list(tonnx.iter_fields(body)) == list(jonnx.iter_fields(body))


def test_arcface_onnx_trees_equal_jax(tmp_path, iresnet_sd):
    path = str(tmp_path / "arcface_ir18.onnx")
    write_onnx(path, dict(reversed(list(iresnet_sd.items()))))  # any order
    assert_same_tree(tonnx.load_arcface_onnx(path, "iresnet_18"),
                     jonnx.load_arcface_onnx(path, "iresnet_18"))
    assert_same_tree(tonnx.convert_iresnet_weights(iresnet_sd, "iresnet_18"),
                     jonnx.convert_iresnet_weights(iresnet_sd, "iresnet_18"))


def test_onnx_unnamed_initializers_error(tmp_path, rng):
    path = str(tmp_path / "anon.onnx")
    write_onnx(path, {"603": rng.normal(size=(4, 4)).astype(np.float32)})
    for mod in (jonnx, tonnx):
        with pytest.raises(ValueError, match="torch-named"):
            mod.load_arcface_onnx(path, "iresnet_18")


def test_onnx_not_a_model_errors(tmp_path):
    path = str(tmp_path / "empty.onnx")
    with open(path, "wb") as f:
        f.write(b"\x08\x07")  # ir_version only, no graph
    for mod in (jonnx, tonnx):
        with pytest.raises(ValueError, match="no graph"):
            mod.load_onnx_initializers(path)


# ------------------------------------------------------------------- export

def _port_unfolded_tree(arch, seed):
    """A JAX-format tree taken from the port's own unfolded module."""
    model = tirse.build_backbone(arch, folded=False)
    lecun_normal_(model, torch.Generator().manual_seed(seed))
    _bn_noise(model, seed)
    return backbone_variables_from_state(model.state_dict()), model


@pytest.mark.parametrize("arch", ["ir_micro", "ir_micro_se", "iresnet_18"])
def test_exports_equal_jax_byte_for_byte(arch, monkeypatch):
    cfg = {"units": (1, 1, 1, 1), "use_se": True}
    monkeypatch.setitem(jirse.BACKBONE_CONFIGS, "ir_micro_se", cfg)
    monkeypatch.setitem(tirse.BACKBONE_CONFIGS, "ir_micro_se", cfg)
    tree, model = _port_unfolded_tree(arch, 3)
    assert_same_statedict(texport.export_statedict(tree, arch),
                          jexport.export_statedict(tree, arch))
    if arch == "iresnet_18":
        assert_same_statedict(texport.export_iresnet_statedict(tree, arch),
                              jexport.export_iresnet_statedict(tree, arch))
    # the tree carries the port's module exactly: back into it bit for bit
    sd = backbone_state_from_jax(tree, folded=False)
    for k, v in model.state_dict().items():
        assert torch.equal(sd[k], v), k


def test_ckpt_and_iresnet_files_round_trip(tmp_path):
    tree, _ = _port_unfolded_tree("ir_micro", 4)
    path = str(tmp_path / "exported.ckpt")
    texport.save_adaface_checkpoint(tree, "ir_micro", path)
    blob = torch.load(path, map_location="cpu", weights_only=True)
    assert all(k.startswith("model.") for k in blob["state_dict"])
    assert_same_tree(timport.load_adaface_checkpoint(path, "ir_micro"),
                     jimport.load_adaface_checkpoint(path, "ir_micro"))
    jpath = str(tmp_path / "jax.ckpt")
    jexport.save_adaface_checkpoint(tree, "ir_micro", jpath)
    jblob = torch.load(jpath, map_location="cpu", weights_only=True)
    assert_same_statedict({k: v.numpy() for k, v in blob["state_dict"].items()},
                          {k: v.numpy() for k, v in jblob["state_dict"].items()})

    itree, _ = _port_unfolded_tree("iresnet_18", 5)
    ipath = str(tmp_path / "iresnet18.pt")
    texport.save_iresnet_statedict(itree, "iresnet_18", ipath)
    jipath = str(tmp_path / "jax_iresnet18.pt")
    jexport.save_iresnet_statedict(itree, "iresnet_18", jipath)
    iblob = torch.load(ipath, map_location="cpu", weights_only=True)
    jiblob = torch.load(jipath, map_location="cpu", weights_only=True)
    assert_same_statedict({k: v.numpy() for k, v in iblob.items()},
                          {k: v.numpy() for k, v in jiblob.items()})


def test_export_refuses_folded_tree_and_wrong_family():
    from facerecognitionpipeline_tpu_torch.models.fold import fold_inference_variables

    tree, _ = _port_unfolded_tree("ir_micro", 6)
    folded = fold_inference_variables(tree)
    for mod in (jexport, texport):
        with pytest.raises(ValueError, match="folded"):
            mod.export_statedict(folded, "ir_micro")
        with pytest.raises(ValueError, match="export_statedict"):
            mod.export_iresnet_statedict(tree, "ir_micro")
        with pytest.raises(ValueError, match="SE"):
            mod.export_iresnet_statedict(tree, "ir_se_50")


# ------------------------------------------------------------------- MTCNN

def _mtcnn_statedicts(variables):
    """JAX-format detector variables -> the published MTCNN torch naming
    (conv4_1 / dense5_1 heads for P/R-net, fc1-style names for O-net)."""
    names = {
        "pnet": {"cls": "conv4_1", "reg": "conv4_2"},
        "rnet": {"fc1": "dense4", "cls": "dense5_1", "reg": "dense5_2"},
        "onet": {},
    }
    out = {}
    for net, tree in variables.items():
        sd = {}
        for layer, leaves in tree["params"].items():
            name = names[net].get(layer, layer)
            if "alpha" in leaves:
                sd[f"{name}.weight"] = torch.from_numpy(np.asarray(leaves["alpha"]).copy())
                continue
            k = np.asarray(leaves["kernel"])
            w = k.transpose(3, 2, 0, 1) if k.ndim == 4 else k.T
            sd[f"{name}.weight"] = torch.from_numpy(np.ascontiguousarray(w))
            sd[f"{name}.bias"] = torch.from_numpy(np.asarray(leaves["bias"]).copy())
        out[net] = sd
    return out


def test_mtcnn_statedict_equals_jax(tmp_path):
    from facerecognitionpipeline_tpu.models.detector_nets import (
        load_mtcnn_torch_statedict as jload,
    )
    from facerecognitionpipeline_tpu_torch.models.detector import MTCNNDetector
    from facerecognitionpipeline_tpu_torch.models.detector_nets import (
        load_mtcnn_torch_statedict as tload,
    )
    from facerecognitionpipeline_tpu_torch.utils.io import load_npz_variables

    npz = "pretrained/mtcnn_synthetic.npz"
    variables = load_npz_variables(npz)
    blob = _mtcnn_statedicts(variables)
    assert_same_tree(tload(blob), jload(blob))
    assert_same_tree(tload(blob), variables)
    path = str(tmp_path / "mtcnn.pt")
    torch.save(blob, path)
    det = MTCNNDetector(det_size=(96, 96), weights_path=path, device="cpu")
    ref = MTCNNDetector(det_size=(96, 96), weights_path=npz, device="cpu")
    for k, v in ref.nets.state_dict().items():
        assert torch.equal(det.nets.state_dict()[k], v), k
    for load in (jload, tload):
        with pytest.raises(KeyError, match="conv1.weight"):
            load({"pnet": {}, "rnet": {}, "onet": {}})
        renamed = {**blob, "pnet": {k.replace("conv4_1", "head"): v
                                    for k, v in blob["pnet"].items()}}
        with pytest.raises(KeyError, match="none of"):
            load(renamed)


# ---------------------------------------------------------------- embedder

@pytest.fixture(scope="module")
def faces():
    rng = np.random.default_rng(3)
    return rng.integers(0, 256, (3, 112, 112, 3), dtype=np.uint8)


@pytest.mark.parametrize("kind", ["ckpt", "onnx", "npz"])
def test_face_embedder_on_the_same_file_as_jax(kind, ref_sd, iresnet_sd, faces, tmp_path):
    from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as JEmbedder
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder
    from facerecognitionpipeline_tpu_torch.utils.io import save_npz_variables

    if kind == "onnx":
        path, arch, mtype = str(tmp_path / "w.onnx"), "iresnet_18", "arcface"
        write_onnx(path, iresnet_sd)
    elif kind == "ckpt":
        path, arch, mtype = str(tmp_path / "w.ckpt"), "ir_18", "adaface"
        torch.save({"state_dict": {f"model.{k}": v for k, v in ref_sd.items()}}, path)
    else:
        path, arch, mtype = str(tmp_path / "w.npz"), "ir_18", "adaface"
        save_npz_variables(path, jimport.convert_statedict(ref_sd, "ir_18"))
    port = FaceEmbedder(arch, model_path=path, model_type=mtype, device="cpu")
    jax_e = JEmbedder(arch, model_path=path, model_type=mtype)
    assert port.pretrained and jax_e.pretrained
    # one array of 112 crops, and a list of crops of other sizes (cv2 resize)
    crops = [faces[0], faces[1][:100, :90], np.ascontiguousarray(faces[2][::2])]
    for batch in (faces, crops):
        got = port.extract_embeddings_batch(batch)
        want = jax_e.extract_embeddings_batch(batch)
        assert got.shape == want.shape == (3, 512) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=1e-4)
    np.testing.assert_allclose(port.extract_embedding(faces[0]), got[0], atol=1e-6)


def test_face_embedder_missing_file_and_defaults(tmp_path, capsys):
    from facerecognitionpipeline_tpu.pipeline import embedder as jemb
    from facerecognitionpipeline_tpu_torch.pipeline import embedder as temb

    for ext in (".ckpt", ".onnx", ".npz"):
        with pytest.raises(FileNotFoundError, match="not found"):
            temb.FaceEmbedder("ir_micro", model_path=str(tmp_path / f"none{ext}"),
                              model_type="arcface", device="cpu")
    for table in ("ADAFACE_MODELS", "ARCFACE_MODELS"):
        got, want = getattr(temb, table), getattr(jemb, table)
        assert {k: v.split("/")[-1] for k, v in got.items()} == {
            k: v.split("/")[-1] for k, v in want.items()}
    # the table's files are absent: random init, with the warning
    e = temb.FaceEmbedder("ir_micro", device="cpu")
    assert not e.pretrained
    assert "random init" in capsys.readouterr().err


def test_similarity_helpers_equal_jax(rng):
    from facerecognitionpipeline_tpu.pipeline.embedder import FaceEmbedder as J
    from facerecognitionpipeline_tpu_torch.pipeline.embedder import FaceEmbedder as T

    a, b = rng.normal(size=512).astype(np.float32), rng.normal(size=512).astype(np.float32)
    g = rng.normal(size=(7, 512)).astype(np.float32)
    assert T.compute_similarity(a, b) == J.compute_similarity(a, b)
    np.testing.assert_array_equal(T.compute_similarity_batch(a, g), J.compute_similarity_batch(a, g))
    for method in ("mean", "median", "weighted_mean"):
        np.testing.assert_array_equal(T.aggregate_embeddings(g, method),
                                      J.aggregate_embeddings(g, method))
    np.testing.assert_array_equal(T.aggregate_embeddings(g[:1]), g[0])
    for bad, match in (((g, "max"), "Unknown"), ((g[:0],), "empty")):
        with pytest.raises(ValueError, match=match):
            T.aggregate_embeddings(*bad)
